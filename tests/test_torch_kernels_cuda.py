"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

The checks are chip_smoke.py's own (the decode-attention kernels' cuda
tests on the reference's cases are in tests/test_torch_decode_kernel.py):
  * daxpy: bit-exact, on tests/test_kernels.py's shapes and dtypes, every
    length 1..5000 and unaligned views, and at n = 2^24;
  * fused AdamW: m and v bit-exact, p within one ULP, on
    tests/test_kernels.py's cases;
  * decode attention: the serving shape with the new token on the first or
    last slot of a chunk of the scores kernel's split, and the cases that
    take the kernels' scalar-load build (rows that are no multiple of 16
    bytes, caches off a 16-byte boundary): caches bit-exact, out within
    chip_smoke.py's ``TOL``.

This file imports neither jax nor the reference package, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest tests/test_torch_kernels_cuda.py -m cuda

Every test needs a card and skips itself where there is none.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import daxpy as DX
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import fused_adamw as FA


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip: see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_daxpy_kernel_matches_plain_version(card):
    before = DX.LAUNCHES
    assert SMOKE.check_daxpy(card)["max_abs_err"] == 0.0
    assert DX.LAUNCHES > before


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_daxpy_kernel_bit_exact_at_2_24(card, dt):
    x, y = SMOKE._daxpy_inputs(2 ** 24, card)
    x, y = x.to(SMOKE._dtype(dt)), y.to(SMOKE._dtype(dt))
    assert torch.equal(DX.daxpy(-1.75, x, y), DX.daxpy_plain(-1.75, x, y))


DECODE_CASES = [(c, 0) for c in SMOKE.EDGE_CASES] + SMOKE.SCALAR_LOAD_CASES


@pytest.mark.cuda
@pytest.mark.parametrize("case,offset", DECODE_CASES,
                         ids=[c[0] for c, _ in DECODE_CASES])
def test_decode_attention_kernels_match_plain_version(card, case, offset):
    before = DA.LAUNCHES
    SMOKE.check_case(case, 0, card, offset)
    assert DA.LAUNCHES == before + 1      # one count per call, two launches


@pytest.mark.cuda
@pytest.mark.parametrize("case", SMOKE.ADAMW_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in SMOKE.ADAMW_CASES])
def test_fused_adamw_kernel_matches_plain_version(card, case):
    shape, dt, step = case
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    g = torch.Generator().manual_seed(1)
    p = torch.randn(shape, generator=g).to(dtype).to(card)
    gr = (torch.randn(shape, generator=g) * 0.1).to(dtype).to(card)
    m = (torch.randn(shape, generator=g) * 0.01).to(card)
    v = (torch.randn(shape, generator=g).abs() * 0.001).to(card)
    hp = FA.pack_hparams(**SMOKE.ADAMW_HPS, step=step, device=card)
    before = FA.LAUNCHES
    res = SMOKE.check_adamw_tensors(str(case), p, gr, m, v, hp)
    assert res["p_max_ulps"] <= 1 and FA.LAUNCHES == before + 1


@pytest.mark.cuda
def test_fused_adamw_kernel_rejects_what_it_does_not_take(card):
    hp = FA.pack_hparams(**SMOKE.ADAMW_HPS, step=1, device=card)
    p = torch.zeros(256, device=card)
    with pytest.raises(TypeError):       # f32 p with bf16 g
        FA.fused_adamw(p, p.bfloat16(), p.clone(), p.clone(), hp)
    with pytest.raises(ValueError):      # moments on the CPU
        FA.fused_adamw(p, p.clone(), p.cpu(), p.cpu(), hp)
    with pytest.raises(ValueError):      # a strided view
        q = torch.zeros(256, 2, device=card)[:, 0]
        FA.fused_adamw(q, q.clone(), p.clone(), p.clone(), hp)
