"""Heads and gating of the PyTorch port against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu import gating as jax_gating
from openwakeword_tpu.models import heads as jax_heads
from openwakeword_tpu_torch import convert, gating
from openwakeword_tpu_torch.models import heads

ATOL = 1e-5   # float32 heads on the CPU: reassociation only


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


def _perturb_norms(p, rng):
    for k in [k for k in p if k.endswith("ln") or k == "ln1"]:
        d = p[k]["gamma"].shape[0]
        p[k] = {"gamma": (0.5 + rng.random(d)).astype(np.float32),
                "beta": (0.2 * (rng.random(d) - 0.5)).astype(np.float32)}
    return p


def _both(p):
    meta = dict(p["__meta__"])
    jp = jax.tree.map(jnp.asarray, {k: v for k, v in p.items() if k != "__meta__"})
    tp = convert.head_from_jax(p)
    return meta, jp, {k: v for k, v in tp.items() if k != "__meta__"}


@pytest.mark.parametrize("kind,kwargs", [
    ("dnn", dict(n_blocks=1)),
    ("dnn", dict(n_blocks=2, layer_dim=32)),
    ("mlp", dict(input_frames=34, n_classes=7, layer_dim=128)),
    ("mlp", dict(input_frames=8, n_classes=3, layer_dim=16, relu_logits=False)),
    ("rnn", dict()),
    ("rnn", dict(input_frames=12, n_classes=4)),
    ("rnn", dict(bf16_weights=True)),
    ("rnn", dict(input_frames=6, n_classes=3, bf16_weights=True)),
])
def test_forward_matches_jax(rng, kind, kwargs):
    """float32 heads, and rnn heads on bf16 weights (as the engine's 'bf16'
    tier stores them): their products are 1-pass in both packages."""
    kwargs = dict(kwargs)
    relu_logits = kwargs.pop("relu_logits", None)
    bf16_weights = kwargs.pop("bf16_weights", False)
    p = _perturb_norms(heads.init_params(rng, kind, **kwargs), rng)
    if relu_logits is not None:
        p["__meta__"]["relu_logits"] = relu_logits
    meta, jp, tp = _both(p)
    if bf16_weights:
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.ndim >= 2 else a, jp)
        tp = {k: {n: t.to(torch.bfloat16) if t.ndim >= 2 else t for n, t in v.items()} for k, v in tp.items()}
    x = rng.standard_normal((5, meta["input_frames"], 96)).astype(np.float32)
    for inference in (True, False):
        want = np.asarray(jax_heads.forward(jp, jnp.asarray(x), meta, inference=inference))
        got = heads.forward(tp, torch.from_numpy(x), meta, inference=inference).numpy()
        assert got.shape == (5, meta["n_classes"])
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_rnn_head_ignores_precision(rng):
    """The rnn head's products follow its weights' dtype, not ``precision``
    (JAX ``heads._lstm_scan`` and ``_apply_linear(..., precision=None)``)."""
    p = heads.init_params(rng, "rnn")
    meta, _, tp = _both(p)
    x = torch.from_numpy(rng.standard_normal((3, 16, 96)).astype(np.float32))
    fp32 = heads.forward(tp, x, meta)
    for precision in ("fast", "bf16", "high"):
        torch.testing.assert_close(heads.forward(tp, x, meta, precision=precision), fp32, rtol=0, atol=0)


@pytest.mark.parametrize("kind,kwargs", [("dnn", {}), ("mlp", dict(n_classes=4, layer_dim=32))])
def test_forward_stacked_matches_jax(rng, kind, kwargs):
    ps = [_perturb_norms(heads.init_params(rng, kind, **kwargs), rng) for _ in range(3)]
    meta = dict(ps[0]["__meta__"])
    jstack = jax_heads.stack_params([jax.tree.map(jnp.asarray, {k: v for k, v in p.items() if k != "__meta__"})
                                     for p in ps])
    tstack = heads.stack_params([convert.head_from_jax(p) for p in ps])
    x = rng.standard_normal((4, meta["input_frames"], 96)).astype(np.float32)
    want = np.asarray(jax_heads.forward_stacked(jstack, jnp.asarray(x), meta))
    got = heads.forward_stacked(tstack, torch.from_numpy(x), meta).numpy()
    assert got.shape == (4, 3, meta["n_classes"])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # stacking changes nothing against evaluating each head alone
    for h, p in enumerate(ps):
        one = heads.forward(convert.head_from_jax(p), torch.from_numpy(x), meta).numpy()
        np.testing.assert_allclose(got[:, h], one, rtol=0, atol=ATOL)


# ---- gating, against openwakeword_tpu.gating run with xp=numpy ----

def _hist(rng, s=3, n_labels=4, h=30):
    return rng.random((s, n_labels, h)).astype(np.float32)


def test_warmup_zero_matches_numpy(rng):
    scores = rng.random((3, 4)).astype(np.float32)
    ticks = np.array([0, 4, 9], np.int32)
    want = jax_gating.warmup_zero(np, scores, ticks)
    got = gating.warmup_zero(torch.from_numpy(scores), torch.from_numpy(ticks)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("patience", [[0, 1, 2, 5], [3, 3, 3, 3]])
def test_patience_filter_matches_numpy(rng, patience):
    scores, hist = rng.random((3, 4)).astype(np.float32), _hist(rng)
    pat = np.array(patience, np.int32)
    thr = np.array([0.2, 0.3, 0.1, 0.05], np.float32)
    want = jax_gating.patience_filter(np, scores, hist, pat, thr)
    got = gating.patience_filter(torch.from_numpy(scores), torch.from_numpy(hist),
                                 torch.from_numpy(pat), torch.from_numpy(thr)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("frames,active", [(1, None), (4, None), (4, [True, False, True, True])])
def test_debounce_filter_matches_numpy(rng, frames, active):
    scores, hist = rng.random((3, 4)).astype(np.float32), _hist(rng)
    thr = np.array([0.9, 0.5, np.inf, 0.95], np.float32)
    act = None if active is None else np.array(active)
    want = jax_gating.debounce_filter(np, scores, hist, thr, frames, act)
    got = gating.debounce_filter(torch.from_numpy(scores), torch.from_numpy(hist), torch.from_numpy(thr),
                                 frames, None if act is None else torch.from_numpy(act)).numpy()
    np.testing.assert_array_equal(got, want)


def test_push_history_matches_numpy(rng):
    scores, hist = rng.random((3, 4)).astype(np.float32), _hist(rng)
    got = gating.push_history(torch.from_numpy(hist), torch.from_numpy(scores)).numpy()
    np.testing.assert_array_equal(got, jax_gating.push_history(np, hist, scores))


@pytest.mark.parametrize("args", [({"a": 2}, {"a": 0.5}, 1.0), ({"a": 2}, None, 0.0), (None, None, 1.0)])
def test_validate_gating_args_raises_like_jax(args):
    with pytest.raises(ValueError) as want:
        jax_gating.validate_gating_args(*args)
    with pytest.raises(ValueError) as got:
        gating.validate_gating_args(*args)
    assert str(got.value) == str(want.value)
    assert gating.validate_gating_args({"a": 2}, {"a": 0.5}, 0.0) == (True, False)
