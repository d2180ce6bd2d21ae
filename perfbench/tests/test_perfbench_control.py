"""The comparison must fail what it exists to catch, on the CPU at a small
size: the control (the program's own 1-pass path, the precision below the
configuration's) and the faults a cell can have, planted under a run that
skips the harness's look for a card. The cells run on one chip, so no
exchange between chips can be left out."""

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import run, spec  # noqa: E402
from perfbench.tests.test_perfbench_spec import CELLS, small  # noqa: E402

SEED = 2 ** 31 + 4242


def _run(name, control=False):
    return run.execute(small(spec.load(name)), SEED, 0.5, False, torch.device("cpu"), control=control)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    result = _run(name, control=True)
    assert not result["correct"]
    assert result["checks"]["score_gap"]["value"] > result["checks"]["score_gap"]["limit"]


def _state_unchanged(step):
    def faulty(self, st, *args, **kwargs):
        _, scores = step(self, st, *args, **kwargs)
        return st, scores
    return faulty


def _half_batch(step):
    """Rows of the second half keep their state, and their scores are the
    mean of the first half's."""
    def faulty(self, st, chunk, *args, **kwargs):
        new, scores = step(self, st, chunk, *args, **kwargs)
        h = scores.shape[0] // 2

        def keep(n, o):
            if isinstance(n, dict):
                return {k: keep(v, o[k]) for k, v in n.items()}
            return torch.cat([n[:h], o[h:]])
        scores = torch.cat([scores[:h], scores[:h].mean(dim=0, keepdim=True).expand(scores.shape[0] - h, -1)])
        return keep(new, st), scores
    return faulty


def _altered_answer(step):
    def faulty(self, *args, **kwargs):
        new, scores = step(self, *args, **kwargs)
        scores = scores.clone()
        scores[:, 0] += 0.01
        return new, scores
    return faulty


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _altered_answer])
def test_a_fault_in_the_timed_path_is_not_correct(name, fault, monkeypatch):
    from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine
    monkeypatch.setattr(MultiStreamEngine, "_step", fault(MultiStreamEngine._step))
    assert not _run(name)["correct"]
