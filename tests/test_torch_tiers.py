"""The port's 1-pass bf16 arithmetic, module by module, against JAX references
that really round.

On the CPU, JAX's ``Precision.DEFAULT`` is exact float32, so the JAX engine
at 'fast' does not round; the references here round explicitly: the mel
kernels' steps written out with ``jnp`` bf16 casts over the JAX package's
own constants, the CNN through JAX's Pallas kernel in interpret mode (its
``_dot`` casts) and its ``_conv_taps``, the heads on bf16 weights (JAX's
``x.astype(w.dtype)``).

Tolerances. A 1-pass function and its reference round the same operands
but sum in another order, so a value rounded after a float32 sum can flip
to the neighbouring bf16 value: one bf16 ulp, at most 2**-7 of itself.
* Mel: the rounded power and mel weights are non-negative, so a band moves
  by at most 2**-7 of itself: 10*log10(1 + 2**-7) = 0.0339 dB on top of the
  float32 tolerance 2e-3 dB.
* One conv with the same input: no rounding follows the sum, so float32
  reassociation only: 1e-4 (the JAX CNN kernel tests' tolerance) relative
  to the output's scale.
* A stack of layers (CNN, heads): a flipped rounding feeds the next layer,
  where it flips more, so two orders of summation each land within the
  1-pass error E of the float32 result and differ by at most 2 E, with E =
  max |port 1-pass - port float32| on the same inputs.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu.models import embedding as jax_embedding
from openwakeword_tpu.models import heads as jax_heads
from openwakeword_tpu.ops import cnn_pallas
from openwakeword_tpu.ops import melspec_pallas as jax_mel
from openwakeword_tpu_torch import config, convert
from openwakeword_tpu_torch.models import embedding, heads
from openwakeword_tpu_torch.ops import bf16, cnn_step, melspec, melspec_cuda
from openwakeword_tpu_torch.ops.bf16 import round_bf16

MEL_TOL_DB = 2e-3 + 10 * math.log10(1 + 2 ** -7)
CONV_RTOL = 1e-4
S_KERNEL = 64   # one tile of the JAX CNN kernel in interpret mode


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


def _bf(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def _dot(a, b):
    """The TPU kernels' 1-pass product: bf16 operands, float32 sums."""
    return jnp.dot(_bf(a), _bf(b), preferred_element_type=jnp.float32)


def _db(mel):
    return jnp.log(jnp.maximum(mel, config.MEL_AMIN)) * (10.0 / np.log(10.0))


def jax_mel_1pass(windows: np.ndarray, dft: str) -> np.ndarray:
    """``melspec_pallas._make_kernel`` / ``_make_factored_kernel`` at
    ``precision=None`` with the TPU's 1-pass products written out, over the
    JAX package's ``_consts`` / ``_factored_consts`` (jitted: XLA's CPU
    runtime takes bf16 x bf16 -> f32 dots only in compiled programs)."""
    return np.asarray(jax.jit(_jax_mel_1pass, static_argnums=1)(jnp.asarray(windows), dft))


def _jax_mel_1pass(w, dft):
    out = []
    if dft == "direct":
        cos, sin, melw = jax_mel._consts()
        for j in range(jax_mel.FRAMES):
            frames = w[:, jax_mel.HOP * j:jax_mel.HOP * j + jax_mel.N_FFT]
            re, im = _dot(frames, cos), _dot(frames, sin)
            out.append(_db(_dot(re * re + im * im, melw)))
    else:
        fcos, fim, melw = jax_mel._factored_consts()
        sub = jax_mel.SUB
        win_d = jnp.swapaxes(w.reshape(w.shape[0], -1, jax_mel.RADIX), -1, -2)
        for j in range(jax_mel.FRAMES):
            res, ims = [], []
            for b in range(jax_mel.RADIX):
                s = win_d[:, b, jax_mel._BRANCH_HOP * j:jax_mel._BRANCH_HOP * j + sub]
                res.append(_dot(s, fcos[b]))
                ims.append(_dot(s, fim[b]))
            e_re, e_im = res[0] + res[2], ims[0] + ims[2]
            o_re, o_im = res[1] + res[3], ims[1] + ims[3]
            p0 = (e_re + o_re) ** 2 + (e_im + o_im) ** 2
            d_re, d_im = res[0] - res[2], ims[0] - ims[2]
            f_re, f_im = res[1] - res[3], ims[1] - ims[3]
            p1 = (d_re + f_im) ** 2 + (d_im - f_re) ** 2
            p2 = ((e_re - o_re) ** 2 + (e_im - o_im) ** 2)[:, :1]
            mel = _dot(p0, melw[:sub]) + _dot(p1, melw[sub:2 * sub]) + p2 * melw[2 * sub:]
            out.append(_db(mel))
    return jnp.stack(out, axis=1)


@pytest.mark.parametrize("dft", ["direct", "factored"])
@pytest.mark.parametrize("n_streams", [1, 5, 17])
def test_mel_plain_1pass_matches_jax_rounding(rng, dft, n_streams):
    """The plain versions of K1-1pass and K2-1pass (``melspec_cuda``'s CPU
    path) against the TPU kernels' rounding points, with a silent stream."""
    w = (rng.uniform(-1, 1, (n_streams, 1760)) * 25000).astype(np.float32)
    silent = n_streams // 2 if n_streams > 1 else None
    if silent is not None:
        w[silent] = 0.0
    x = torch.from_numpy(w)
    got = melspec_cuda.melspectrogram_frames(x, dft, arith="1pass").numpy()
    want = jax_mel_1pass(w, dft)
    assert got.shape == want.shape == (n_streams, 8, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_TOL_DB)
    # 1-pass is another function than float32: rounding the window alone moves it
    f32 = melspec_cuda.melspectrogram_frames(x, dft).numpy()
    assert np.abs(got - f32).max() > 2e-3
    if silent is not None:
        np.testing.assert_allclose(got[silent], -100.0, atol=1e-4)


def test_mel_1pass_device_constants_are_rounded():
    """The kernels' 1-pass constants: the basis and mel weights rounded to
    bf16, as bf16 planes in each tensor-core kernel's layout. K1-1pass's,
    un-permuted (``mma_columns``, the mel weights transposed), are
    ``round_bf16`` of the float32 kernel's constants bit for bit, zero in the
    padded bins. K2-1pass's basis rows are ``round_bf16`` of the float32
    stage-1 bases' live columns (``factored_mma_columns``, K in (branch,
    tap) order), zero past them, and its mel weights the rounded filterbank
    rows of those columns' bins, followed by the bin-256 row as float32,
    since it multiplies an unrounded power."""
    basis, melw = melspec_cuda._device_consts(torch.device("cpu"), "direct", "1pass")
    basis32, melw32 = melspec_cuda._device_consts(torch.device("cpu"), "direct")
    bins, padded = melspec_cuda.mma_bins(), melspec_cuda.live_bins()[2]
    assert basis.dtype == melw.dtype == torch.bfloat16
    assert basis.shape == (1, 2 * bins, 512) and melw.shape == (1, 32, bins)
    got = torch.zeros((512, 2 * bins))
    got[:, torch.from_numpy(melspec_cuda.mma_columns())] = basis[0].float().t()
    torch.testing.assert_close(got[:, :2 * padded], round_bf16(basis32), rtol=0, atol=0)
    assert not got[:, 2 * padded:].any()
    got_melw = melw[0].float().t()
    torch.testing.assert_close(got_melw[:padded], round_bf16(melw32), rtol=0, atol=0)
    assert not got_melw[padded:].any()
    basis, melw = melspec_cuda._device_consts(torch.device("cpu"), "factored", "1pass")
    first, count, padded, _, _ = melspec_cuda.factored_columns()
    cols = torch.from_numpy(melspec_cuda.factored_mma_columns())
    live = cols >= 0
    bases32 = melspec.f32_const(melspec.factored_dft_bases(), "cpu")                     # (4, 128, 256)
    want = bases32[:, :, cols[live]].permute(2, 0, 1).reshape(-1, 512)
    assert basis.dtype == melw.dtype == torch.bfloat16 and basis.shape == (1, 2 * padded, 512)
    torch.testing.assert_close(basis[0, live].float(), round_bf16(want), rtol=0, atol=0)
    assert not basis[0, ~live].any()
    fb32 = melspec.f32_const(melspec.mel_filterbank(), "cpu")
    got_melw = melw[:-64].view(32, padded).float().t()
    torch.testing.assert_close(got_melw[:count], round_bf16(fb32[first:first + count]), rtol=0, atol=0)
    assert not got_melw[count:].any()
    torch.testing.assert_close(melw[-64:].view(torch.float32), fb32[-1], rtol=0, atol=0)


@pytest.fixture(scope="module")
def folded():
    """(JAX folded, port folded) from checkpoint-layout weights with
    non-trivial BatchNorm statistics."""
    rng = np.random.default_rng(11)
    p = embedding.init_params(rng)
    for k in [k for k in p if k.startswith("bn_")]:
        c = p[k]["gamma"].shape[0]
        p[k] = {"gamma": (0.7 + 0.5 * rng.random(c)).astype(np.float32),
                "beta": (0.3 * (rng.random(c) - 0.5)).astype(np.float32),
                "mean": (0.3 * (rng.random(c) - 0.5)).astype(np.float32),
                "var": (0.8 + 0.4 * rng.random(c)).astype(np.float32)}
    return (jax_embedding.fold_batchnorm(jax.tree.map(jnp.asarray, p)),
            embedding.fold_batchnorm(convert.embedding_from_jax(p)))


def test_mixed_assignment_matches_jax():
    assert embedding.n_convs() == jax_embedding.n_convs() == 20
    assert embedding.MIXED_FAST_CONVS == jax_embedding.MIXED_FAST_CONVS
    assert embedding.mixed_precision() == jax_embedding.mixed_precision()
    for i in range(20):
        assert embedding.layer_precision(embedding.mixed_precision(), i) == \
            jax_embedding.layer_precision(jax_embedding.mixed_precision(), i)
        assert embedding.layer_precision("fast", i) == "fast"


@pytest.mark.parametrize("tier", ["fast", "mixed", "bf16"])
def test_eager_cnn_per_conv_matches_jax_dot(folded, rng, tier):
    """Each conv of the engine's eager NHWC CNN (``embedding.conv``, which
    ``run_program`` runs) on the JAX reference's own input, against JAX's
    ``_conv_taps`` in the mode of ``layer_precision``: ``_dot("bf16")`` for
    the 1-pass convs, "highest" for the rest. At 'bf16' the port's weights
    are stored bf16, as the engine stores them; the convs read them through
    ``embedding.product_params``, as the engine's steps do."""
    j_fold, t_fold = folded
    modes = embedding.mixed_precision() if tier == "mixed" else tier
    if tier == "bf16":
        t_fold = {k: {n: (t.to(torch.bfloat16) if t.ndim >= 2 else t) for n, t in v.items()}
                  for k, v in t_fold.items()}
    t_fold = embedding.product_params(t_fold, modes)
    params = cnn_pallas._prep_params(j_fold, np.float32)
    x = jnp.asarray(rng.uniform(-2, 8, (1, 76, 32, 3)).astype(np.float32))    # (C, T, W, S)
    conv_i = bn_i = 0
    n_one_pass = 0
    for entry in cnn_pallas._layer_plan():
        if entry[0] == "stem_pad":
            x = jnp.pad(x, ((0, 0), (0, 0), (entry[1], entry[1]), (0, 0)))
        elif entry[0] == "conv":
            _, kh, kw, padding, relu = entry
            if kw > 1 and padding == "SAME":
                x = jnp.pad(x, ((0, 0), (0, 0), (kw // 2, kw // 2), (0, 0)))
            mode = embedding.layer_precision(modes, conv_i)
            one_pass = config.one_pass(mode)
            n_one_pass += one_pass
            want = cnn_pallas._conv_taps(x, jnp.asarray(params[2 * conv_i]), jnp.asarray(params[2 * conv_i + 1]),
                                         kh, kw, "bf16" if one_pass else "highest")
            c = t_fold[f"conv_{conv_i}"]
            got = embedding.conv(torch.from_numpy(np.array(x)).permute(3, 0, 1, 2), c["w"], c["b"], 0, mode)
            want = np.transpose(np.asarray(want), (3, 0, 1, 2))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CONV_RTOL * np.abs(want).max(),
                                       err_msg=f"conv {conv_i} ({mode})")
            x = jnp.asarray(want.transpose(1, 2, 3, 0))
            if relu:
                x = jnp.maximum(x, 0.0)
            conv_i += 1
        elif entry[0] == "bnact":
            if bn_i == 0:
                x = x * params[40][:, :, None, None] + params[41][:, :, None, None]
            x = cnn_pallas._leaky(x)
            bn_i += 1
        elif entry[0] == "pool":
            x = cnn_pallas._pool(x, *entry[1])
    assert n_one_pass == (5 if tier == "mixed" else 20)


def _assert_one_pass_close(got, want, ref32, what=""):
    """|got - want| <= 1e-4 + 2 E, E = max |want - ref32| (module docstring)."""
    got, want, ref32 = (np.asarray(a, np.float32) for a in (got, want, ref32))
    e = float(np.abs(want - ref32).max())
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 + 2 * e, (what, err, e)


def test_plain_cnn_kernels_bf16_match_jax_pallas_interpret(folded, rng):
    """The plain K4-bf16 and K3-bf16 (``CnnStepKernel(precision='bf16')`` on
    the CPU) against JAX's ``CnnStepKernel(precision='bf16')`` in interpret
    mode: a prime (``use_pallas=True``) and two steps, each step fed JAX's
    caches, so both sides see the same inputs. E comes from the port's
    float32 kernel on the same inputs. The caches hold the conv inputs
    unrounded on both sides."""
    jk = cnn_pallas.CnnStepKernel(folded[0], sb=S_KERNEL, precision="bf16", interpret=True)
    tk = cnn_step.CnnStepKernel(folded[1], precision="bf16")
    t32 = cnn_step.CnnStepKernel(folded[1], precision="highest")
    window = rng.uniform(-2, 8, (76, 32, S_KERNEL)).astype(np.float32)
    j_caches, j_emb = jk.prime(jnp.asarray(window), use_pallas=True)
    t_caches, t_emb = tk.prime(torch.from_numpy(window))
    r_caches, r_emb = t32.prime(torch.from_numpy(window))
    assert t_emb.shape == (96, S_KERNEL) and t_emb.dtype == torch.float32
    _assert_one_pass_close(t_emb, j_emb, r_emb, "prime emb")
    for k in j_caches:
        _assert_one_pass_close(t_caches[k], j_caches[k], r_caches[k], f"prime {k}")
    np.testing.assert_array_equal(t_caches["cache_0"].numpy(), np.asarray(j_caches["cache_0"]))
    for i in range(2):
        new = rng.uniform(-2, 8, (8, 32, S_KERNEL)).astype(np.float32)
        same = {k: torch.from_numpy(np.array(v)) for k, v in j_caches.items()}
        t_caches, t_emb = tk.step(same, torch.from_numpy(new))
        r_caches, r_emb = t32.step(same, torch.from_numpy(new))
        j_caches, j_emb = jk.step(j_caches, jnp.asarray(new))
        _assert_one_pass_close(t_emb, j_emb, r_emb, f"step {i} emb")
        for k in j_caches:
            _assert_one_pass_close(t_caches[k], j_caches[k], r_caches[k], f"step {i} {k}")


def test_plain_cnn_bf16_rounds_every_conv_input(folded, rng):
    """The plain K3-bf16 rounds the cache rows it reads, not only the new
    rows: caches given unrounded and given rounded to bf16 step to the same
    embedding, while the float32 step tells them apart."""
    tk = cnn_step.CnnStepKernel(folded[1], precision="bf16")
    t32 = cnn_step.CnnStepKernel(folded[1], precision="highest")
    caches, _ = t32.prime(torch.from_numpy(rng.uniform(-2, 8, (76, 32, 4)).astype(np.float32)))
    rounded = {k: round_bf16(v) for k, v in caches.items()}
    new = torch.from_numpy(rng.uniform(-2, 8, (8, 32, 4)).astype(np.float32))
    torch.testing.assert_close(tk.step(caches, new)[1], tk.step(rounded, new)[1], rtol=0, atol=0)
    assert float((t32.step(caches, new)[1] - t32.step(rounded, new)[1]).abs().max()) > 1e-4


def _head_params(rng):
    dnn = heads.init_params(rng, "dnn", input_frames=16, n_blocks=2)
    mlp = heads.init_params(rng, "mlp", input_frames=16, n_classes=4, layer_dim=32)
    dnn2 = heads.init_params(rng, "dnn", input_frames=16, n_blocks=2)
    return dnn, mlp, dnn2


def _to_bf16(tree, lib):
    """>= 2-D float leaves in bf16 (the engines' bf16 cast)."""
    if lib == "jax":
        return jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.ndim >= 2 else a, tree)
    return {k: _to_bf16(v, lib) if isinstance(v, dict) else (v.to(torch.bfloat16) if v.ndim >= 2 else v)
            for k, v in tree.items()}


@pytest.mark.parametrize("tier", ["fast", "bf16"])
def test_heads_1pass_match_jax(rng, tier):
    """``heads.forward`` and ``forward_stacked`` at 'fast' (float32
    weights) and at 'bf16' (bf16 weights), each read through
    ``heads.product_params`` as the engine's steps read them, against
    JAX's heads on bf16 weights, which round the same operands through
    ``x.astype(w.dtype)``. Inputs are stored as the feature ring stores
    them (bf16 at 'bf16'). At 'fast' only the weight matrices are bf16 in
    the reference: biases and norms stay float32."""
    dnn, mlp, dnn2 = _head_params(rng)
    x = rng.normal(0, 1.5, (5, 16, 96)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16 if tier == "bf16" else torch.float32)
    xj = jnp.asarray(xt.float().numpy())

    def jax_p(p):
        p = {k: v for k, v in p.items() if k != "__meta__"}
        return jax.tree.map(jnp.asarray, p)

    for p in (dnn, mlp):
        meta = p["__meta__"]
        tp = convert.head_from_jax(p)
        tp.pop("__meta__")
        jp = jax_p(p)
        jp = {k: dict(v, w=v["w"].astype(jnp.bfloat16)) if "w" in v else v for k, v in jp.items()}
        if tier == "bf16":
            tp = _to_bf16(tp, "torch")
        got = heads.forward(heads.product_params(tp, tier), xt, meta, precision=tier).numpy()
        ref = heads.forward(convert.head_from_jax(p), torch.from_numpy(x), meta, precision="highest").numpy()
        want = np.asarray(jax.jit(lambda q, z: jax_heads.forward(q, z, meta))(jp, xj))
        assert got.dtype == np.float32
        _assert_one_pass_close(got, want, ref, meta["model_type"])

    # stacked heads: JAX's reference is each head's own forward (XLA's CPU
    # runtime has no batched bf16 x bf16 -> f32 dot); at 'bf16' the engine
    # casts after stacking, so the stacked biases and norms are bf16 too
    stacked_t = heads.stack_params([{k: v for k, v in convert.head_from_jax(p).items() if k != "__meta__"}
                                    for p in (dnn, dnn2)])
    ref = heads.forward_stacked(stacked_t, torch.from_numpy(x), dnn["__meta__"], precision="highest").numpy()
    if tier == "bf16":
        stacked_t = _to_bf16(stacked_t, "torch")
    got = heads.forward_stacked(heads.product_params(stacked_t, tier), xt, dnn["__meta__"], precision=tier).numpy()
    want = []
    for p in (dnn, dnn2):
        jp = jax_p(p)
        if tier == "bf16":
            jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
        else:
            jp = {k: dict(v, w=v["w"].astype(jnp.bfloat16)) if "w" in v else v for k, v in jp.items()}
        want.append(np.asarray(jax.jit(lambda q, z: jax_heads.forward(q, z, dnn["__meta__"]))(jp, xj)))
    assert got.shape == (5, 2, 1)
    _assert_one_pass_close(got, np.stack(want, axis=1), ref, "stacked")


def test_bf16_helper_rounds_to_nearest_even():
    one = 1.0 + 2.0 ** -8                   # halfway between 1 and the next bf16 value: ties to 1
    three = 1.0 + 3 * 2.0 ** -8             # halfway between 1 + 2**-7 and 1 + 2**-6: ties to the even 1 + 2**-6
    x = torch.tensor([one, three, 1.0 + 2.0 ** -9, -2.5], dtype=torch.float32)
    torch.testing.assert_close(round_bf16(x), torch.tensor([1.0, 1.0 + 2.0 ** -6, 1.0, -2.5]), rtol=0, atol=0)
    assert round_bf16(x).dtype == torch.float32


@pytest.mark.parametrize("tier", ["highest", "fast", "mixed", "bf16"])
def test_product_params_round_weights_once(folded, rng, tier):
    """The weights a step's products read, built once: each 1-pass conv's
    and linear's weights rounded to bf16 (float32 tensors), the rest float32
    and, where already float32, the same tensors; head biases stay unrounded
    at 'fast'. A 1-pass product then rounds only its activation."""
    t_fold = folded[1]
    modes = embedding.mixed_precision() if tier == "mixed" else tier
    if tier == "bf16":
        t_fold = {k: {n: (t.to(torch.bfloat16) if t.ndim >= 2 else t) for n, t in v.items()}
                  for k, v in t_fold.items()}
    prod = embedding.product_params(t_fold, modes)
    for i in range(embedding.n_convs()):
        w, got = t_fold[f"conv_{i}"]["w"], prod[f"conv_{i}"]["w"]
        assert got.dtype == torch.float32
        if config.one_pass(embedding.layer_precision(modes, i)):
            torch.testing.assert_close(got, round_bf16(w.float()), rtol=0, atol=0)
        else:
            assert got is w
        assert prod[f"conv_{i}"]["b"].dtype == torch.float32
    head = convert.head_from_jax(heads.init_params(rng, "dnn", input_frames=16))
    head.pop("__meta__")
    hp = heads.product_params(head, "fast" if tier == "mixed" else tier)
    for k in ("layer1", "block0_fc", "out"):
        if tier == "highest":
            assert hp[k]["w"] is head[k]["w"]
        else:
            torch.testing.assert_close(hp[k]["w"], round_bf16(head[k]["w"]), rtol=0, atol=0)
        assert hp[k]["b"] is head[k]["b"]

    x, w = torch.randn(4, 5), round_bf16(torch.randn(5, 3))
    xo, wo = bf16.operands(x, w, tier if tier != "mixed" else "fast")
    assert wo is w
    if tier == "highest":
        assert xo is x
    else:
        torch.testing.assert_close(xo, round_bf16(x), rtol=0, atol=0)
