"""The check that decides ``correct`` fails when the timed path is broken.

Each test drives a whole run of a tiny cell on the CPU (the look for a
card skipped) with the engine broken underneath, and sees ``correct`` come
out false: a decode step that leaves the caches as they were, half the
batch's tokens not computed, a token altered where it is produced.  One
card holds each cell, so no exchange between cards can be left out.  The
control (the reference in float8) is kept here at a size a test run holds.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench import control, harness, testkit

CPU = torch.device("cpu")
SEED = 2 ** 31 + 101


class Broken:
    """Forwards to the engine; ``fault`` breaks what ``decode`` returns."""

    def __init__(self, engine, fault):
        self._engine, self._fault, self.steps = engine, fault, 0

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def decode(self, tok, caches, lens):
        self.steps += 1
        return self._fault(self, tok, caches, lens)


def unchanged_state(self, tok, caches, lens):
    """The step computes its tokens but its caches come back as they were."""
    before = [t.clone() for t in _leaves(caches)]
    out = self._engine.decode(tok, caches, lens)
    for t, b in zip(_leaves(caches), before):
        t.copy_(b)
    return out


def half_batch(self, tok, caches, lens):
    """Rows of the second half keep their input token: not computed."""
    nxt, caches, wall = self._engine.decode(tok, caches, lens)
    nxt = np.array(nxt)
    half = len(nxt) // 2
    nxt[half:] = np.asarray(tok).reshape(-1)[half:]
    return nxt, caches, wall


def altered_token(self, tok, caches, lens):
    """A token changed where the step produces it: row 0's, every fifth
    step, so that requests the sample draws carry one."""
    nxt, caches, wall = self._engine.decode(tok, caches, lens)
    if self.steps % 5 == 3:
        nxt = np.array(nxt)
        nxt[0] = (nxt[0] + 1) % self._engine.cfg.vocab_size
    return nxt, caches, wall


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return testkit.make_root(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-moe"])
@pytest.mark.parametrize("fault", [unchanged_state, half_batch,
                                   altered_token],
                         ids=["unchanged_state", "half_batch",
                              "altered_token"])
def test_a_broken_step_is_not_correct(root, name, fault):
    result, lines = harness.run(root, name, SEED, testkit.SECONDS, False, CPU, 0.0,
                                fault=lambda e: Broken(e, fault))
    assert result["correct"] is False
    assert any(result["checks"][k]["value"] > result["checks"][k]["limit"]
               for k in ("logit_gap", "mismatch_share")), lines


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-moe"])
def test_the_unbroken_run_is_correct(root, name):
    result, lines = harness.run(root, name, SEED, testkit.SECONDS, False, CPU, 0.0,
                                fault=lambda e: e)
    assert result["correct"] is True, lines


def test_the_control_fails_where_the_program_passes(tmp_path):
    """bf16 program, float8 control, one tiny dense cell whose backlog of
    12 requests is served to its end: over three seeds the control's
    smallest widest gap is over three times the program's largest."""
    root = testkit.make_root(tmp_path, configs=("tiny-dense-v1024",),
                             dtype="bfloat16", requests=12)
    recs = list(control.readings(root, "tiny-dense-v1024", [5, 6, 7],
                                 float("inf"), CPU, control=3))
    program = max(r["program"]["logit_gap"] for r in recs)
    ctl = min(r["control"]["logit_gap"] for r in recs)
    assert all(r["problems"] == 0 and r["tokens"] > 0 for r in recs)
    assert ctl > 3 * program, recs


def test_the_bf16_witness_reads_between_program_and_control(tmp_path):
    """The witnesses of ``--witness``: the reference in bfloat16 reads a
    mean gap no wider than the float8 control's, and the MoE family's
    bfloat16 router gives the program's tokens a reading of its own."""
    root = testkit.make_root(tmp_path, configs=("tiny-moe",),
                             dtype="bfloat16", requests=12)
    rec, = control.readings(root, "tiny-moe", [5], float("inf"), CPU,
                            control=1, witness=1)
    assert rec["problems"] == 0 and rec["tokens"] > 0
    assert rec["bf16"]["mean_gap"] <= rec["control"]["mean_gap"], rec
    assert set(rec["router_bf16"]) == set(rec["program"])
