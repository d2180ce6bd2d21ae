"""The port's 3-pass bf16 arithmetic (the TPU kernels' ``Precision.HIGH`` /
``_dot`` mode "high") against the JAX package, on the CPU.

The references are the JAX kernels themselves: ``melspectrogram_pallas`` at
``Precision.HIGH`` and ``CnnStepKernel(precision="high")`` in interpret
mode, and ``cnn_pallas._conv_taps(mode="high")``, all of which spell out
the split (``_bf16_split``) and the three bf16 products. A 3-pass function
and its reference take the same exact products and sum them in another
order, so they agree to the float32 tolerances of the JAX kernel tests:
2e-3 dB on the mel frontend (absolute), 1e-4 on the CNN, relative to the
scale of each output (max |value|): over the 20 convs, two float32
evaluations of the 3-pass program in different orders differ by up to
1.7e-4 on prime embeddings of magnitude 10.5, each about 1.6e-4 from the
3-pass program summed in float64 (a CPU measurement, seed 11 weights).

The 3-pass results differ from float32 by the dropped lo * lo terms and the
rounding of lo, well inside those tolerances, so each check also holds the
port closer to the 3-pass reference than to its own float32 version: the
mean distance at least ``CLOSER`` times smaller, on the mel frames and on
the first conv output the CNN exposes (``cache_2``, the input of conv 2:
conv 1's output, where float32 summation noise is smallest; deeper layers
sum over up to 864 terms). Measured on the CPU: the port's plain 3-pass mel
sits 5.5e-6 dB (mean) from JAX's, mostly the noise of JAX's interpret-mode
bf16 dots (4.8e-6 from the float64-summed 3-pass, the port's 7e-7), and
1.2e-5 dB from the port's float32 mel (a ratio of 2.2 at S=5); on
``cache_2`` 4.7e-7 and 8.5e-6. A float32 function fails the check: it sits
nearer the port's float32 version than JAX's 3-pass one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu.models import embedding as jax_embedding
from openwakeword_tpu.ops import cnn_pallas
from openwakeword_tpu.ops import melspec_pallas as jax_mel
from openwakeword_tpu_torch import config, convert
from openwakeword_tpu_torch.models import embedding, embedding_stream
from openwakeword_tpu_torch.ops import bf16, cnn_step, melspec, melspec_cuda
from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine

MEL_TOL_DB = 2e-3      # tests/test_pallas.py
CNN_TOL = 1e-4         # tests/test_cnn_pallas.py
CONV_RTOL = 1e-4
CLOSER = 1.5
S_KERNEL = 64          # one tile of the JAX CNN kernel in interpret mode


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


def _mean_gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).mean())


def _assert_scaled_close(got, want, what=""):
    """|got - want| <= CNN_TOL * max |want| (module docstring)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=CNN_TOL * np.abs(want).max(), err_msg=what)


def _assert_closer(got, want3, want32, what=""):
    """``got`` sits at least CLOSER times nearer ``want3`` than ``want32``,
    in mean absolute distance."""
    d3, d32 = _mean_gap(got, want3), _mean_gap(got, want32)
    assert d32 > 0 and d3 * CLOSER <= d32, (what, d3, d32)


# ---------------------------------------------------------------------------
# the split


def test_split_matches_jax_bf16_split(rng):
    """hi and lo are bit-equal to JAX's ``_bf16_split`` over values of every
    scale, signs and zeros; hi + lo is exact in float32 and within 2**-16 of
    x, relative."""
    x = (rng.standard_normal(20000) * np.exp(rng.uniform(-30, 30, 20000))).astype(np.float32)
    x[:8] = [0.0, -0.0, 1.0, -1.0, 3.0, 32767.0, -32768.0, 1e-3]
    hi, lo = bf16.split_bf16(torch.from_numpy(x))
    j_hi, j_lo = jax_mel._bf16_split(jnp.asarray(x))
    np.testing.assert_array_equal(hi.numpy().view(np.uint32),
                                  np.asarray(j_hi.astype(jnp.float32)).view(np.uint32))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32),
                                  np.asarray(j_lo.astype(jnp.float32)).view(np.uint32))
    total = hi + lo
    np.testing.assert_array_equal(total.numpy().astype(np.float64), hi.numpy().astype(np.float64) + lo.numpy())
    rel = np.abs(total.numpy().astype(np.float64) - x) / np.maximum(np.abs(x), 1e-30)
    assert rel.max() <= 2.0 ** -16


def test_product_3pass_is_jax_three_dots(rng):
    """``product_3pass(matmul)`` is JAX's three-dot ``_dot`` at HIGH."""
    a = rng.standard_normal((16, 64)).astype(np.float32)
    b = rng.standard_normal((64, 24)).astype(np.float32)
    got = bf16.product_3pass(torch.matmul, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    a_hi, a_lo = jax_mel._bf16_split(jnp.asarray(a))
    b_hi, b_lo = jax_mel._bf16_split(jnp.asarray(b))
    dot = jax.jit(lambda x, y: jnp.dot(x, y, preferred_element_type=jnp.float32))
    want = np.asarray(dot(a_hi, b_hi) + dot(a_hi, b_lo) + dot(a_lo, b_hi))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    _assert_closer(got, want, a @ b)


def test_mel_device_constants_are_host_split():
    """The 3-pass kernels' constants, made on the host: a hi and a lo bf16
    plane in each tensor-core kernel's layout. K1-3pass's, un-permuted
    (``mma_columns``, the mel weights transposed), are ``split_bf16`` of the
    float32 kernel's basis and mel weights, bit for bit, zero in the padded
    bins. K2-3pass's basis rows are ``split_bf16`` of the float32 stage-1
    bases' live columns (``factored_mma_columns``, K in (branch, tap)
    order), zero past them, and its mel weights the split filterbank rows of
    those columns' bins, followed by the bin-256 row as float32 bits."""
    basis, melw = melspec_cuda._device_consts(torch.device("cpu"), "direct", "3pass")
    basis32, melw32 = melspec_cuda._device_consts(torch.device("cpu"), "direct")
    bins, padded = melspec_cuda.mma_bins(), melspec_cuda.live_bins()[2]
    assert basis.dtype == melw.dtype == torch.bfloat16
    assert basis.shape == (2, 2 * bins, 512) and melw.shape == (2, 32, bins)
    cols = torch.from_numpy(melspec_cuda.mma_columns())
    for plane, want_basis, want_melw in zip(range(2), bf16.split_bf16(basis32), bf16.split_bf16(melw32)):
        got = torch.zeros((512, 2 * bins))
        got[:, cols] = basis[plane].float().t()
        assert torch.equal(got[:, :2 * padded], want_basis) and not got[:, 2 * padded:].any()
        got_melw = melw[plane].float().t()
        assert torch.equal(got_melw[:padded], want_melw) and not got_melw[padded:].any()
    basis, melw = melspec_cuda._device_consts(torch.device("cpu"), "factored", "3pass")
    first, count, padded, _, _ = melspec_cuda.factored_columns()
    cols = torch.from_numpy(melspec_cuda.factored_mma_columns())
    live = cols >= 0
    bases32 = melspec.f32_const(melspec.factored_dft_bases(), "cpu")                     # (4, 128, 256)
    want = bases32[:, :, cols[live]].permute(2, 0, 1).reshape(-1, 512)
    fb32 = melspec.f32_const(melspec.mel_filterbank(), "cpu")
    assert basis.dtype == melw.dtype == torch.bfloat16 and basis.shape == (2, 2 * padded, 512)
    got_melw = melw[:-64].view(2, 32, padded)
    for plane, want_basis, want_melw in zip(range(2), bf16.split_bf16(want),
                                            bf16.split_bf16(fb32[first:first + count])):
        assert torch.equal(basis[plane, live].float(), want_basis) and not basis[plane, ~live].any()
        assert torch.equal(got_melw[plane].float().t()[:count], want_melw) and not got_melw[plane, :, count:].any()
    assert torch.equal(melw[-64:].view(torch.float32), fb32[-1])


def _assert_planes_are_jax_split(t3, t32, j_tap):
    """``t3``, a conv's 3-pass weight planes, against the float32 taps ``t32``
    ((kh*kw, Cout, Cin)) and JAX's tap stack of the same conv: a (2, Cout,
    K16) bf16 tensor whose hi and lo planes over K = kh*kw*Cin, in the tap
    order (dt, dw, c), are ``split_bf16`` of the taps and, bit for bit,
    JAX's ``_bf16_split`` of them; zero from K to K16."""
    taps, cout, cin = t32.shape
    k = taps * cin
    assert t3.dtype == torch.bfloat16 and t3.shape == (2, cout, -(-k // 16) * 16) and t3.is_contiguous()
    assert not t3[:, :, k:].float().any()
    hi, lo = (t3[plane, :, :k].float().reshape(cout, taps, cin).permute(1, 0, 2) for plane in range(2))
    want_hi, want_lo = bf16.split_bf16(t32)
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    assert t32.shape == j_tap.shape
    j_hi, j_lo = jax_mel._bf16_split(jnp.asarray(t32.numpy()))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(j_hi.astype(jnp.float32)))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(j_lo.astype(jnp.float32)))


def test_cnn_weights_are_host_split_once(folded):
    """``prep_params(arith='3pass')`` gives the 3-pass kernels each conv's
    taps split once on the host, as bf16 hi and lo planes laid [Cout][K16]
    (``_assert_planes_are_jax_split``), bit for bit as JAX's ``_bf16_split``
    splits them (JAX's ``_dot`` splits the same (Cout, Cin) tap matrices, in
    the same layout as ``cnn_pallas._prep_params``), and keeps the plain
    version's matrices and the biases float32."""
    p3, p32 = cnn_step.prep_params(folded[1], "3pass"), cnn_step.prep_params(folded[1])
    j_params = cnn_pallas._prep_params(folded[0], np.float32)
    assert p3.arith == "3pass" and p32.arith == "fp32"
    for i, (t3, t32) in enumerate(zip(p3.taps, p32.taps)):
        _assert_planes_are_jax_split(t3, t32, j_params[2 * i])
    for a, b in zip(p3.mats + p3.biases, p32.mats + p32.biases):
        assert torch.equal(a, b)


@pytest.mark.parametrize("conv", range(20))
def test_cnn_weight_planes_per_conv(folded, conv):
    """``cnn_step.weight_planes(..., '3pass')`` of each conv's taps on their
    own, as ``prep_params`` stores them, bit for bit JAX's split; bf16
    weights go in as their float32 values (their lo plane is zero)."""
    t32 = cnn_step.prep_params(folded[1]).taps[conv]
    j_tap = cnn_pallas._prep_params(folded[0], np.float32)[2 * conv]
    planes = cnn_step.weight_planes(t32, "3pass")
    assert torch.equal(planes, cnn_step.prep_params(folded[1], "3pass").taps[conv])
    _assert_planes_are_jax_split(planes, t32, j_tap)
    rounded = t32.to(torch.bfloat16)
    planes16 = cnn_step.weight_planes(rounded, "3pass")
    assert torch.equal(planes16[0, :, :t32.shape[0] * t32.shape[2]].float(),
                       rounded.float().permute(1, 0, 2).reshape(t32.shape[1], -1))
    assert not planes16[1].float().any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("conv", range(20))
def test_cnn_one_pass_plane_per_conv(folded, conv, dtype):
    """``prep_params(..., '1pass')`` gives the 1-pass kernels (K3-bf16,
    K4-bf16) each conv's weights as one (1, Cout, K16) bf16 plane: bit for
    bit JAX's ``_prep_params(folded, np.float32)`` taps cast to bf16 (as its
    ``_dot`` casts them in mode 'bf16'), row o over K = kh*kw*Cin in the
    tap order (dt, dw, c), zero from K to K16; the hi plane of the 3-pass
    planes; and the same from float32 weights and from bf16 ones (which
    JAX's ``_prep_params`` takes as their float32 values)."""
    j_folded, t_folded = folded
    if dtype == torch.bfloat16:
        t_folded = {k: {n: t.to(dtype) if n == "w" else t for n, t in v.items()} for k, v in t_folded.items()}
        j_folded = {k: {n: jnp.asarray(a, jnp.bfloat16) if n == "w" else a for n, a in v.items()}
                    for k, v in j_folded.items()}
    j_tap = cnn_pallas._prep_params(j_folded, np.float32)[2 * conv]        # (kh*kw, Cout, Cin)
    taps, cout, cin = j_tap.shape
    k = taps * cin
    plane = cnn_step.prep_params(t_folded, "1pass").taps[conv]
    assert plane.dtype == torch.bfloat16 and plane.shape == (1, cout, -(-k // 16) * 16) and plane.is_contiguous()
    assert not plane[:, :, k:].float().any()
    want = np.asarray(jnp.asarray(j_tap).astype(jnp.bfloat16)).transpose(1, 0, 2).reshape(cout, k)
    np.testing.assert_array_equal(plane[0, :, :k].view(torch.int16).numpy(), want.view(np.int16))
    t32 = cnn_step.prep_params(t_folded).taps[conv]
    assert torch.equal(plane[0], cnn_step.weight_planes(t32, "3pass")[0])
    assert torch.equal(plane, cnn_step.weight_planes(t32, "1pass"))


@pytest.mark.parametrize("arith", ["high", "3-pass", None])
def test_unknown_arithmetic_raises(folded, arith):
    with pytest.raises(ValueError, match="unknown arithmetic"):
        melspec_cuda.melspectrogram_frames(torch.zeros((1, 1760)), arith=arith)
    with pytest.raises(ValueError, match="unknown arithmetic"):
        cnn_step.prep_params(folded[1], arith)


def test_modes_map_to_the_jax_arithmetic():
    """Each mode's kernel arithmetic, as ``melspec_pallas`` and
    ``cnn_pallas._dot`` select it; ``CnnStepKernel`` takes the same map."""
    assert [config.kernel_arith(m) for m in config.MODES] == ["fp32", "3pass", "1pass", "1pass"]
    assert config.three_pass("high") and not config.three_pass("highest") and not config.one_pass("high")


# ---------------------------------------------------------------------------
# the mel frontend (K1-3pass, K2-3pass)


@pytest.mark.parametrize("dft", ["direct", "factored"])
@pytest.mark.parametrize("n_streams", [1, 5, 17])
def test_mel_plain_3pass_matches_jax_high(rng, dft, n_streams):
    """The plain K1-3pass / K2-3pass (``melspec_cuda``'s CPU path) against
    JAX's Pallas mel kernel at ``Precision.HIGH`` in interpret mode, with a
    silent stream (-100 dB): within 2e-3 dB, and nearer it than the port's
    float32 version."""
    w = (rng.uniform(-1, 1, (n_streams, 1760)) * 25000).astype(np.float32)
    silent = n_streams // 2 if n_streams > 1 else None
    if silent is not None:
        w[silent] = 0.0
    x = torch.from_numpy(w)
    got = melspec_cuda.melspectrogram_frames(x, dft, "3pass").numpy()
    want = np.asarray(jax_mel.melspectrogram_pallas(jnp.asarray(w), tile_s=8, interpret=True, dft=dft,
                                                    precision=jax.lax.Precision.HIGH))
    f32 = melspec_cuda.melspectrogram_frames(x, dft).numpy()
    assert got.shape == want.shape == (n_streams, 8, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_TOL_DB)
    _assert_closer(got, want, f32, dft)
    if silent is not None:
        np.testing.assert_allclose(got[silent], -100.0, atol=1e-4)


def test_mel_plain_3pass_silence():
    for dft in melspec_cuda.DFTS:
        got = melspec_cuda.melspectrogram_frames(torch.zeros((3, 1760)), dft, "3pass")
        np.testing.assert_allclose(got.numpy(), -100.0, atol=1e-4)


# ---------------------------------------------------------------------------
# the CNN (K3-high, K4-high)


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


def test_per_conv_3pass_matches_jax_conv_taps(folded, rng):
    """Each conv of the plain K3-high/K4-high (``embedding_stream._conv_t``
    at '3pass' on the prepped matrices) on the JAX reference's own input,
    against ``cnn_pallas._conv_taps(mode="high")``, within 1e-4 of the
    output's scale; the 3-pass conv nearer it than the float32 conv."""
    params = cnn_pallas._prep_params(folded[0], np.float32)
    mats = cnn_step.prep_params(folded[1], "3pass").mats
    x = jnp.asarray(rng.uniform(-2, 8, (1, 76, 32, 3)).astype(np.float32))     # (C, T, W, S)
    conv_i = bn_i = 0
    for entry in cnn_pallas._layer_plan():
        if entry[0] == "stem_pad":
            x = jnp.pad(x, ((0, 0), (0, 0), (entry[1], entry[1]), (0, 0)))
        elif entry[0] == "conv":
            _, kh, kw, padding, relu = entry
            if kw > 1 and padding == "SAME":
                x = jnp.pad(x, ((0, 0), (0, 0), (kw // 2, kw // 2), (0, 0)))
            want = np.asarray(cnn_pallas._conv_taps(x, jnp.asarray(params[2 * conv_i]),
                                                    jnp.zeros_like(params[2 * conv_i + 1]), kh, kw, "high"))
            xt = torch.from_numpy(np.array(x))
            got = embedding_stream._conv_t(xt, mats[conv_i], kh, kw, "3pass").numpy()
            f32 = embedding_stream._conv_t(xt, mats[conv_i], kh, kw).numpy()
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=CONV_RTOL * np.abs(want).max(),
                                       err_msg=f"conv {conv_i}")
            if conv_i < 2:     # short sums (K = 9, 72): float32 noise far below the split's effect
                _assert_closer(got, want, f32, f"conv {conv_i}")
            x = jnp.asarray(want) + params[2 * conv_i + 1][:, :, None, None]
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
    assert conv_i == 20


def test_plain_cnn_kernels_high_match_jax_pallas_interpret(folded, rng):
    """The plain K4-high and K3-high (``CnnStepKernel(precision='high')`` on
    the CPU, the default precision, as in JAX) against JAX's
    ``CnnStepKernel(precision='high')`` in interpret mode: a prime
    (``use_pallas=True``) and two steps, each step fed JAX's caches, within
    1e-4 of each tensor's scale on the embedding and every cache; conv 1's
    output (``cache_2``) nearer JAX's than the port's float32 kernel's."""
    jk = cnn_pallas.CnnStepKernel(folded[0], sb=S_KERNEL, precision="high", interpret=True)
    tk = cnn_step.CnnStepKernel(folded[1])
    t32 = cnn_step.CnnStepKernel(folded[1], precision="highest")
    assert tk.precision == jk.precision == "high" and tk.params.arith == "3pass"
    window = rng.uniform(-2, 8, (76, 32, S_KERNEL)).astype(np.float32)
    j_caches, j_emb = jk.prime(jnp.asarray(window), use_pallas=True)
    t_caches, t_emb = tk.prime(torch.from_numpy(window))
    r_caches, _ = t32.prime(torch.from_numpy(window))
    assert t_emb.shape == (96, S_KERNEL) and t_emb.dtype == torch.float32
    _assert_scaled_close(t_emb, j_emb, "prime emb")
    for k in j_caches:
        _assert_scaled_close(t_caches[k], j_caches[k], f"prime {k}")
    _assert_closer(t_caches["cache_2"].numpy(), np.asarray(j_caches["cache_2"]), r_caches["cache_2"], "prime")
    for i in range(2):
        new = rng.uniform(-2, 8, (8, 32, S_KERNEL)).astype(np.float32)
        same = {k: torch.from_numpy(np.array(v)) for k, v in j_caches.items()}
        t_caches, t_emb = tk.step(same, torch.from_numpy(new))
        r_caches, _ = t32.step(same, torch.from_numpy(new))
        j_caches, j_emb = jk.step(j_caches, jnp.asarray(new))
        _assert_scaled_close(t_emb, j_emb, f"step {i} emb")
        for k in j_caches:
            _assert_scaled_close(t_caches[k], j_caches[k], f"step {i} {k}")
        _assert_closer(t_caches["cache_2"].numpy(), np.asarray(j_caches["cache_2"]), r_caches["cache_2"],
                       f"step {i}")


def test_plain_cnn_high_keeps_caches_unsplit(folded, rng):
    """The caches hold the conv inputs as computed: the 3-pass prime's
    cache_0 is the mel window's last two rows, unsplit, as in JAX."""
    window = torch.from_numpy(rng.uniform(-2, 8, (76, 32, 3)).astype(np.float32))
    caches, _ = cnn_step.CnnStepKernel(folded[1]).prime(window)
    torch.testing.assert_close(caches["cache_0"][0, :, 1:-1], window[-2:], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the engine's mel stage


@pytest.mark.parametrize("precision, mel_dft, arith", [
    ("high", "factored", "3pass"), ("mixed", "direct", "3pass"), ({"mel": "high", "cnn": "highest"}, "direct", "3pass"),
    ({"mel": "highest"}, "factored", "fp32"), ("highest", "direct", "fp32")])
def test_engine_mel_stage_picks_the_mode_variant(precision, mel_dft, arith):
    """The engine's mel stage calls the mel kernel in the arithmetic of its
    mel mode, once per step: 3-pass at 'high', 'mixed' and {'mel': 'high'},
    float32 at 'highest'."""
    calls = []
    real = melspec_cuda.melspectrogram_frames_plain

    def spy(windows, dft, arith="fp32"):
        calls.append((dft, arith))
        return real(windows, dft, arith)
    engine = MultiStreamEngine(n_streams=2, precision=precision, mel_dft=mel_dft, device="cpu")
    pcm = np.random.default_rng(4).integers(-3000, 3000, (3, 2, 1280)).astype(np.int16)
    melspec_cuda.melspectrogram_frames_plain = spy
    try:
        scores = engine.predict_frames(pcm)
    finally:
        melspec_cuda.melspectrogram_frames_plain = real
    assert calls == [(mel_dft, arith)] * 3
    assert np.isfinite(scores).all()
