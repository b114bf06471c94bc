"""Streaming serving on a four-process gloo 2x2 (data, model) mesh.

``serve_workload(ServeConfig(mesh_shape=(2, 2)))`` with a
``torch.distributed`` group initialised builds the engine's ``DeviceMesh``:
params and caches are DTensors placed by ``param_specs``/``cache_specs``,
the fused decode step runs on each device's batch rows of the whole cache,
and every step's credits count the mesh's four devices.  The greedy token
streams of chatglm3-6b reduced (8 requests of the CLI's trace) equal the
one-device run's (``mesh_shape=(1, 1)``, no process group), token for
token, and so do the admissions.
"""

from __future__ import annotations

import json

import pytest

from repro_torch.serve import ServeConfig, WorkloadSpec, serve_workload

SPEC = WorkloadSpec(num_requests=8)


def _streams(out) -> dict:
    return {str(r.rid): [int(t) for t in r.generated]
            for r in out["requests"] if r.generated is not None}


def _worker(rank, world, store, out_path):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        out = serve_workload(SPEC, config=ServeConfig(
            device="cpu", mesh_shape=(2, 2), fused_decode=True))
        if rank == 0:
            s = out["metrics"].summary()
            with open(out_path, "w") as f:
                json.dump({"streams": _streams(out),
                           "admitted": s["admitted"],
                           "rejected": s["rejected"]}, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("serve")
    mp.start_processes(_worker, args=(4, str(d / "store"), str(d / "o.json")),
                       nprocs=4, join=True, start_method="spawn")
    return json.loads((d / "o.json").read_text())


def test_mesh_serve_tokens_equal_one_device(mesh_run):
    out = serve_workload(SPEC, config=ServeConfig(device="cpu",
                                                  fused_decode=True))
    s = out["metrics"].summary()
    assert mesh_run["streams"] == _streams(out)
    assert (mesh_run["admitted"], mesh_run["rejected"]) == \
        (s["admitted"], s["rejected"])
    assert sum(len(v) for v in mesh_run["streams"].values()) > 0


def test_engine_without_a_group_is_the_one_device_path():
    from repro_torch.serve.batcher import ServingEngine
    eng = ServingEngine("chatglm3-6b", device="cpu")
    assert eng.mesh is None and eng.sync.threshold == 1
