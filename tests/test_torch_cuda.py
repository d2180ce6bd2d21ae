"""The port's CUDA kernels on the card: built from ``csrc/``, each held
against its plain PyTorch version (mel frontend: kernels 1 and 2, 2e-3 dB;
CNN step and prime: kernels 3 and 4, 1e-4; their 1-pass bf16 variants at
the tolerances derived below; their 3-pass variants at the fp32 kernels'
tolerances, 1e-4 of each tensor's scale on the CNN, and nearer the plain
3-pass version than the plain fp32 one). Marked ``cuda``; skipped where no NVIDIA GPU
is present. Run on a GPU host with
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``
(``conftest.py`` imports jax, which the port's GPU host need not have)."""

import math

import numpy as np
import pytest
import torch

from openwakeword_tpu_torch import convert
from openwakeword_tpu_torch.models import embedding
from openwakeword_tpu_torch.ops import cnn_step, cnn_step_cuda, melspec_cuda
from openwakeword_tpu_torch.ops.bf16 import round_bf16

pytestmark = pytest.mark.cuda

# A 1-pass variant and its plain version round the same operands, but a
# value rounded to bf16 after a float32 sum (the mel power) can land on the
# other side of a rounding midpoint when the sum's order differs: it moves by
# one bf16 ulp, at most 2**-7 of itself. The power and the mel weights are
# non-negative, so a mel band moves by at most 2**-7 of itself, 10*log10(1 +
# 2**-7) dB, on top of the float32 tolerance.
MEL_1PASS_TOL_DB = 2e-3 + 10 * math.log10(1 + 2 ** -7)
# Such a move is rare: with the plain version's sums in float64, about 1e-4
# of the dB values move by more than 2e-3 dB (a CPU rehearsal); a variant
# that skipped the power's rounding would move about 60% of them.
MEL_1PASS_SHARE = 0.01


def assert_rounds_its_inputs(got, run, inputs, what=""):
    """A 1-pass CNN kernel rounds every input as it stages it: on the inputs
    rounded to bf16 beforehand it returns the same embedding bit for bit,
    and the same caches after rounding (a cache may hold an input row as
    given). The rounded inputs keep the inputs' 16-byte alignment, so the
    same copy variant runs."""
    def rounded(t):
        shift = t.data_ptr() % 16 // t.element_size()
        view = torch.empty(t.numel() + shift, device=t.device)[shift:].view(t.shape)
        return view.copy_(round_bf16(t))
    assert not all(torch.equal(t, round_bf16(t)) for t in inputs), what
    emb, caches = run(*[rounded(t) for t in inputs])
    assert torch.equal(emb, got[0]), what
    assert all(torch.equal(round_bf16(a), round_bf16(b)) for a, b in zip(caches, got[1])), what


def assert_one_pass_close(got, want, ref32, what=""):
    """The CNN's 1-pass check. Each conv input is rounded after a float32
    sum, so one flipped rounding (one bf16 ulp) feeds every later conv, where
    it flips more: two 1-pass evaluations of the 20-conv program in two
    orders of summation (the kernel's k16 tensor-core steps, the plain
    version's products) each sit within the 1-pass error E of the float32
    result, so they differ by at most 2 E, E = max |want - ref32| taken on
    the same inputs (plus the float32 tolerance). And ``got`` must be 1-pass:
    at least E / 2 away from the float32 result where E is above it."""
    err = float((got - want).abs().max())
    e = float((want - ref32).abs().max())
    assert err <= 1e-4 + 2 * e, (what, err, e)
    if e > 1e-4:
        assert float((got - ref32).abs().max()) >= e / 2, (what, e)


# A 3-pass variant and its plain version take the same exact products and
# sum them in other orders, so they agree to float32 summation noise; the
# 3-pass and fp32 functions differ by the dropped lo * lo terms and lo's
# rounding, which stand above that noise on the mel frames and on conv 1's
# output: a 3-pass kernel must sit at least THREE_PASS_CLOSER times nearer
# its plain 3-pass version than the plain fp32 one there (mean |diff|). The
# mel kernels' own fp32 sums over 512 samples (K2-3pass's sequential FFMAs,
# K1-3pass's tensor-core steps added with FADD) carry under half the
# 3-pass-to-fp32 gap (ratios near 2.5 on an H100, PERF.md); an fp32 kernel
# would sit nearer the plain fp32 version (a ratio below 1).
THREE_PASS_CLOSER = 1.25
# A 1-pass CNN kernel and its plain version round the same operands and sum
# the exact products in other orders; the 1-pass and fp32 functions differ by
# every operand's rounding, about 2**-9 of it. On conv 1's output, before
# flipped roundings can pile up, a 1-pass kernel must sit at least
# ONE_PASS_CLOSER times nearer its plain 1-pass version than the plain fp32
# one (mean |diff|): the strict check that the general 1e-4 + 2 E bound
# leaves to the later convs.
ONE_PASS_CLOSER = 10


def assert_nearer(got, want, want32, what="", closer=THREE_PASS_CLOSER):
    """``got`` at least ``closer`` times nearer ``want`` (the plain version
    of its arithmetic) than ``want32`` (the plain fp32 one), in mean |diff|."""
    d = float((got.double() - want.double()).abs().mean())
    d32 = float((got.double() - want32.double()).abs().mean())
    assert d32 > 0 and d * closer <= d32, (what, d, d32)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dft", ["direct", "factored"])
@pytest.mark.parametrize("n_streams", [1, 5, 17, 1000])
def test_mel_kernel_matches_plain(cuda, n_streams, dft):
    w = (np.random.default_rng(n_streams).uniform(-1, 1, (n_streams, 1760)) * 25000).astype(np.float32)
    w[n_streams // 2] = 0.0
    x = torch.from_numpy(w).to(cuda)
    before = melspec_cuda.melspectrogram_frames.launches[dft]
    got = melspec_cuda.melspectrogram_frames(x, dft)
    want = melspec_cuda.melspectrogram_frames_plain(x, dft)
    torch.cuda.synchronize()
    assert melspec_cuda.melspectrogram_frames.launches[dft] == before + 1
    assert got.shape == (n_streams, 8, 32)
    assert float((got - want).abs().max()) <= 2e-3
    assert float((got[n_streams // 2] + 100.0).abs().max()) <= 1e-4


@pytest.mark.parametrize("n_streams", [7, 9, 63, 65, 4095])
def test_live_bin_kernel_ragged_streams(cuda, n_streams):
    """Kernel 1 tiles 8 streams per block over the live DFT bins: a last
    block with 1..7 streams, held against the unpruned plain version, with
    a silent stream in that last block."""
    w = (np.random.default_rng(n_streams).uniform(-1, 1, (n_streams, 1760)) * 25000).astype(np.float32)
    w[-1] = 0.0
    x = torch.from_numpy(w).to(cuda)
    got = melspec_cuda.melspectrogram_frames(x, "direct")
    want = melspec_cuda.melspectrogram_frames_plain(x, "direct")
    torch.cuda.synchronize()
    assert got.shape == (n_streams, 8, 32)
    assert float((got - want).abs().max()) <= 2e-3
    assert float((got[-1] + 100.0).abs().max()) <= 1e-4


@pytest.mark.parametrize("n_streams", [1, 7, 8, 9, 63, 65, 1000, 4095])
def test_factored_kernel_ragged_streams(cuda, n_streams):
    """Kernel 2 tiles 8 streams per block over the live stage-1 columns: a
    last block with 1..8 streams, held against the plain version (all 257
    bins), with a silent stream in that last block; each call launches the
    kernel once."""
    w = (np.random.default_rng(n_streams).uniform(-1, 1, (n_streams, 1760)) * 25000).astype(np.float32)
    w[-1] = 0.0
    x = torch.from_numpy(w).to(cuda)
    before = melspec_cuda.melspectrogram_frames.launches["factored"]
    got = melspec_cuda.melspectrogram_frames(x, "factored")
    want = melspec_cuda.melspectrogram_frames_plain(x, "factored")
    torch.cuda.synchronize()
    assert melspec_cuda.melspectrogram_frames.launches["factored"] == before + 1
    assert got.shape == (n_streams, 8, 32)
    assert float((got - want).abs().max()) <= 2e-3
    assert float((got[-1] + 100.0).abs().max()) <= 1e-4


@pytest.mark.parametrize("dft", ["direct", "factored"])
@pytest.mark.parametrize("n_streams", [1, 5, 17, 63, 65, 1000, 4095])
def test_mel_1pass_kernel_matches_plain(cuda, n_streams, dft):
    """Each 1-pass variant against its plain version at ragged S (K1-1pass's
    and K2-1pass's 16-stream tiles), with a silent stream: within
    MEL_1PASS_TOL_DB, and beyond 2e-3 dB in at most MEL_1PASS_SHARE of the
    values; it differs from the float32 kernel, and it gives the same
    result, bit for bit, on windows rounded to bf16 beforehand (it rounds
    the samples it stages)."""
    w = (np.random.default_rng(n_streams).uniform(-1, 1, (n_streams, 1760)) * 25000).astype(np.float32)
    silent = n_streams // 2 if n_streams > 1 else None
    if silent is not None:
        w[silent] = 0.0
    x = torch.from_numpy(w).to(cuda)
    name = melspec_cuda.variant(dft, "1pass")
    before = melspec_cuda.melspectrogram_frames.launches[name]
    got = melspec_cuda.melspectrogram_frames(x, dft, arith="1pass")
    want = melspec_cuda.melspectrogram_frames_plain(x, dft, arith="1pass")
    f32 = melspec_cuda.melspectrogram_frames_plain(x, dft)
    torch.cuda.synchronize()
    assert melspec_cuda.melspectrogram_frames.launches[name] == before + 1
    assert got.shape == (n_streams, 8, 32) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= MEL_1PASS_TOL_DB
    assert float(((got - want).abs() > 2e-3).float().mean()) <= MEL_1PASS_SHARE
    assert float((got - f32).abs().max()) > 2e-3
    assert torch.equal(melspec_cuda.melspectrogram_frames(round_bf16(x), dft, arith="1pass"), got)
    if silent is not None:
        assert float((got[silent] + 100.0).abs().max()) <= 1e-4


@pytest.mark.parametrize("dft", ["direct", "factored"])
@pytest.mark.parametrize("n_streams", [1, 5, 17, 63, 65, 1000, 4095])
def test_mel_3pass_kernel_matches_plain(cuda, n_streams, dft):
    """Each 3-pass variant against its plain version at ragged S, with a
    silent stream: within 2e-3 dB, and nearer the plain 3-pass version than
    the plain fp32 one (``assert_nearer``)."""
    w = (np.random.default_rng(n_streams).uniform(-1, 1, (n_streams, 1760)) * 25000).astype(np.float32)
    silent = n_streams // 2 if n_streams > 1 else None
    if silent is not None:
        w[silent] = 0.0
    x = torch.from_numpy(w).to(cuda)
    name = melspec_cuda.variant(dft, "3pass")
    before = melspec_cuda.melspectrogram_frames.launches[name]
    got = melspec_cuda.melspectrogram_frames(x, dft, arith="3pass")
    want = melspec_cuda.melspectrogram_frames_plain(x, dft, arith="3pass")
    f32 = melspec_cuda.melspectrogram_frames_plain(x, dft)
    torch.cuda.synchronize()
    assert melspec_cuda.melspectrogram_frames.launches[name] == before + 1
    assert got.shape == (n_streams, 8, 32) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 2e-3
    assert_nearer(got, want, f32, name)
    if silent is not None:
        assert float((got[silent] + 100.0).abs().max()) <= 1e-4


@pytest.mark.parametrize("dft", ["direct", "factored"])
@pytest.mark.parametrize("arith", ["1pass", "3pass"])
@pytest.mark.parametrize("n_streams", [15, 16, 17, 31, 32, 33])
def test_mel_tensor_core_kernels_ragged_block(cuda, arith, n_streams, dft):
    """K1-1pass, K1-3pass, K2-1pass and K2-3pass take 16 streams per block
    at the default range:
    both sides of one and two whole blocks, with a silent stream in the last
    block, held to their plain versions as above (1-pass: MEL_1PASS_TOL_DB,
    the share and the bit-equality on rounded windows; 3-pass: 2e-3 dB and
    nearer the plain 3-pass version than the plain fp32 one)."""
    w = (np.random.default_rng(n_streams).uniform(-1, 1, (n_streams, 1760)) * 25000).astype(np.float32)
    w[-1] = 0.0
    x = torch.from_numpy(w).to(cuda)
    got = melspec_cuda.melspectrogram_frames(x, dft, arith=arith)
    want = melspec_cuda.melspectrogram_frames_plain(x, dft, arith=arith)
    f32 = melspec_cuda.melspectrogram_frames_plain(x, dft)
    torch.cuda.synchronize()
    assert got.shape == (n_streams, 8, 32)
    assert float((got[-1] + 100.0).abs().max()) <= 1e-4
    if arith == "1pass":
        assert float((got - want).abs().max()) <= MEL_1PASS_TOL_DB
        assert float(((got - want).abs() > 2e-3).float().mean()) <= MEL_1PASS_SHARE
        assert torch.equal(melspec_cuda.melspectrogram_frames(round_bf16(x), dft, arith="1pass"), got)
    else:
        assert float((got - want).abs().max()) <= 2e-3
        assert_nearer(got[:-1], want[:-1], f32[:-1], n_streams)


@pytest.mark.parametrize("dft", ["direct", "factored"])
def test_mel_3pass_kernel_nearer_at_scale(cuda, dft):
    """K1-3pass and K2-3pass at S=4096, the engine's scale: their
    tensor-core sums keep them THREE_PASS_CLOSER times nearer the plain
    3-pass version than the plain fp32 one."""
    w = (np.random.default_rng(4096).uniform(-1, 1, (4096, 1760)) * 25000).astype(np.float32)
    x = torch.from_numpy(w).to(cuda)
    got = melspec_cuda.melspectrogram_frames(x, dft, arith="3pass")
    want = melspec_cuda.melspectrogram_frames_plain(x, dft, arith="3pass")
    f32 = melspec_cuda.melspectrogram_frames_plain(x, dft)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 2e-3
    assert_nearer(got, want, f32, "S=4096")


@pytest.fixture()
def wide_mel_range(monkeypatch):
    """config.FMAX = 7000: 222 live bins padded to 224, 14 warps per block,
    which do not divide the block's 64 rows. The library, kernel entry and
    constants are rebuilt for it, and again for the default afterwards."""
    from openwakeword_tpu_torch import config
    from openwakeword_tpu_torch.utils import cuda_build
    caches = (cuda_build.load_library, melspec_cuda._kernel_fn, melspec_cuda._device_consts)
    monkeypatch.setattr(config, "FMAX", 7000.0)
    for cache in caches:
        cache.cache_clear()
    yield config
    for cache in caches:
        cache.cache_clear()


@pytest.mark.parametrize("n_streams", [1, 9, 1000])
def test_live_bin_kernel_other_live_range(cuda, wide_mel_range, n_streams):
    """Kernel 1 built for another live range, held against the unpruned
    257-bin DFT projected onto that range's filterbank."""
    from openwakeword_tpu_torch.ops import melspec
    config = wide_mel_range
    assert melspec_cuda.live_bins() == (2, 222, 224)
    w = (np.random.default_rng(n_streams).uniform(-1, 1, (n_streams, 1760)) * 25000).astype(np.float32)
    w[-1] = 0.0
    x = torch.from_numpy(w).to(cuda)
    got = melspec_cuda.melspectrogram_frames(x, "direct")
    fb = melspec.mel_filterbank(config.SAMPLE_RATE, config.N_FFT, config.N_MELS, config.FMIN, config.FMAX)
    spec = melspec.frame_signal(x.double()) @ torch.from_numpy(melspec.stft_power_basis()).to(cuda)
    power = spec[..., 0::2] ** 2 + spec[..., 1::2] ** 2
    want = 10.0 * torch.log10(torch.clamp_min(power @ torch.from_numpy(fb).to(cuda), 1e-10))
    torch.cuda.synchronize()
    assert got.shape == (n_streams, 8, 32)
    assert float((got.double() - want).abs().max()) <= 2e-3
    assert float((got[-1] + 100.0).abs().max()) <= 1e-4


def _live_range_frames(x, arith, dft="direct"):
    """The plain version's function in ``arith`` ('fp32', '1pass', '3pass')
    with the filterbank as ``config`` now sets it: the plain version follows
    ``config`` as the kernels do."""
    return melspec_cuda.melspectrogram_frames_plain(x, dft, arith)


@pytest.mark.parametrize("dft", ["direct", "factored"])
@pytest.mark.parametrize("arith", ["1pass", "3pass"])
@pytest.mark.parametrize("n_streams", [9, 17, 1000])
def test_tensor_core_kernels_other_live_range(cuda, wide_mel_range, arith, n_streams, dft):
    """The tensor-core variants built for another live range, with a silent
    stream, held as in ``test_mel_1pass_kernel_matches_plain`` /
    ``test_mel_3pass_kernel_matches_plain`` to the plain products over that
    range (``_live_range_frames``): K1-1pass and K1-3pass over 224 bins (7
    bin warps, 8 streams and 224 threads a block, 32-deep 3-pass K slices); K2-1pass and
    K2-3pass over all 128 stage-1 columns with the c = 1 half live (bins
    128..223: D, F and p1 formed, 64-deep 3-pass K slices)."""
    if dft == "direct":
        assert melspec_cuda.live_bins() == (2, 222, 224) and melspec_cuda.mma_bins() == 224
    else:
        assert melspec_cuda.factored_columns() == (0, 128, 128, True, False)
    w = (np.random.default_rng(n_streams).uniform(-1, 1, (n_streams, 1760)) * 25000).astype(np.float32)
    w[-1] = 0.0
    x = torch.from_numpy(w).to(cuda)
    name = melspec_cuda.variant(dft, arith)
    before = melspec_cuda.melspectrogram_frames.launches[name]
    got = melspec_cuda.melspectrogram_frames(x, dft, arith=arith)
    want = _live_range_frames(x, arith, dft)
    f32 = _live_range_frames(x, "fp32", dft)
    torch.cuda.synchronize()
    assert melspec_cuda.melspectrogram_frames.launches[name] == before + 1
    assert got.shape == (n_streams, 8, 32) and got.dtype == torch.float32
    assert float((got[-1] + 100.0).abs().max()) <= 1e-4
    if arith == "1pass":
        assert float((got - want).abs().max()) <= MEL_1PASS_TOL_DB
        assert float(((got - want).abs() > 2e-3).float().mean()) <= MEL_1PASS_SHARE
        assert float((got - f32).abs().max()) > 2e-3
        assert torch.equal(melspec_cuda.melspectrogram_frames(round_bf16(x), dft, arith="1pass"), got)
    else:
        assert float((got - want).abs().max()) <= 2e-3
        assert_nearer(got[:-1], want[:-1], f32[:-1], n_streams)


@pytest.mark.parametrize("n_streams", [1, 9, 1000])
def test_factored_kernel_other_live_range(cuda, wide_mel_range, n_streams):
    """Kernel 2 built for another live range, with a silent stream: all 128
    stage-1 columns with the c = 1 half live (bins 128..223: D, F and p1
    formed; 8 column warps in two passes), held to the plain fp32 function
    over that range (``_live_range_frames``) within 2e-3 dB."""
    assert melspec_cuda.factored_columns() == (0, 128, 128, True, False) and melspec_cuda.factored_padded() == 128
    w = (np.random.default_rng(n_streams).uniform(-1, 1, (n_streams, 1760)) * 25000).astype(np.float32)
    w[-1] = 0.0
    x = torch.from_numpy(w).to(cuda)
    before = melspec_cuda.melspectrogram_frames.launches["factored"]
    got = melspec_cuda.melspectrogram_frames(x, "factored")
    want = _live_range_frames(x, "fp32", "factored")
    torch.cuda.synchronize()
    assert melspec_cuda.melspectrogram_frames.launches["factored"] == before + 1
    assert got.shape == (n_streams, 8, 32)
    assert float((got - want).abs().max()) <= 2e-3
    assert float((got[-1] + 100.0).abs().max()) <= 1e-4


@pytest.fixture(params=[8000.0, 9000.0], ids=["fmax8000", "fmax9000"])
def full_band(request, monkeypatch):
    """config.FMAX = 8000, the full band (bins 2..255, 254 live bins padded
    to 256: K1-3pass loads its mel weights after the K loop), and 9000,
    above half the sample rate (bin 256 live too). The library, kernel
    entries and constants are rebuilt for it, and again for the default
    afterwards."""
    from openwakeword_tpu_torch import config
    from openwakeword_tpu_torch.utils import cuda_build
    caches = (cuda_build.load_library, melspec_cuda._kernel_fn, melspec_cuda._device_consts)
    monkeypatch.setattr(config, "FMAX", request.param)
    for cache in caches:
        cache.cache_clear()
    yield request.param
    for cache in caches:
        cache.cache_clear()


@pytest.mark.parametrize("variant", melspec_cuda.VARIANTS)
@pytest.mark.parametrize("n_streams", [1, 9, 1000])
def test_mel_kernels_full_band(cuda, full_band, variant, n_streams):
    """Every mel variant built for the full band and above it, held to its
    plain version over that range (which follows ``config``) at phase 3's
    limits: 2e-3 dB for the fp32 and 3-pass variants, a 3-pass variant
    nearer its plain 3-pass version than the plain fp32 one, a 1-pass
    variant within one flipped power rounding, beyond 2e-3 dB in at most 1%
    of the values, away from the fp32 function and the same on windows
    rounded beforehand; a silent stream at -100 dB."""
    dft, _, arith = variant.partition("_")
    arith = arith or "fp32"
    assert melspec_cuda.live_bins() == (2, 254 if full_band == 8000.0 else 255, 256)
    assert melspec_cuda.factored_columns() == (0, 128, 128, True, full_band > 8000.0)
    w = (np.random.default_rng(n_streams).uniform(-1, 1, (n_streams, 1760)) * 25000).astype(np.float32)
    if n_streams > 1:
        w[-1] = 0.0
    x = torch.from_numpy(w).to(cuda)
    before = melspec_cuda.melspectrogram_frames.launches[variant]
    got = melspec_cuda.melspectrogram_frames(x, dft, arith)
    want = melspec_cuda.melspectrogram_frames_plain(x, dft, arith)
    f32 = melspec_cuda.melspectrogram_frames_plain(x, dft)
    torch.cuda.synchronize()
    assert melspec_cuda.melspectrogram_frames.launches[variant] == before + 1
    assert got.shape == (n_streams, 8, 32) and got.dtype == torch.float32
    if n_streams > 1:
        assert float((got[-1] + 100.0).abs().max()) <= 1e-4
    sounding = slice(0, max(n_streams - 1, 1))
    if arith == "1pass":
        assert float((got - want).abs().max()) <= MEL_1PASS_TOL_DB
        assert float(((got - want).abs() > 2e-3).float().mean()) <= MEL_1PASS_SHARE
        assert float((got[sounding] - f32[sounding]).abs().max()) > 2e-3
        assert torch.equal(melspec_cuda.melspectrogram_frames(round_bf16(x), dft, "1pass"), got)
    else:
        assert float((got - want).abs().max()) <= 2e-3
        if arith == "3pass":
            assert_nearer(got[sounding], want[sounding], f32[sounding], (variant, n_streams))


def test_mel_kernel_rejects_bad_inputs(cuda):
    with pytest.raises(TypeError):
        melspec_cuda.melspectrogram_frames(torch.zeros((2, 1760), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        melspec_cuda.melspectrogram_frames(torch.zeros((2, 1761), device=cuda))
    with pytest.raises(ValueError):
        melspec_cuda.melspectrogram_frames(torch.zeros((1760, 2), device=cuda).t())


@pytest.fixture(scope="module")
def cnn_params():
    rng = np.random.default_rng(11)
    p = embedding.init_params(rng)
    for k in [k for k in p if k.startswith("bn_")]:
        c = p[k]["gamma"].shape[0]
        p[k] = {"gamma": (0.7 + 0.5 * rng.random(c)).astype(np.float32),
                "beta": (0.3 * (rng.random(c) - 0.5)).astype(np.float32),
                "mean": (0.3 * (rng.random(c) - 0.5)).astype(np.float32),
                "var": (0.8 + 0.4 * rng.random(c)).astype(np.float32)}
    return embedding.fold_batchnorm(convert.embedding_from_jax(p))


# both sides of the 32-stream block tile and of S % 4 == 0 (the 16-byte-copy
# variant takes S % 4 == 0, the 4-byte one the rest)
@pytest.mark.parametrize("n_streams", [1, 3, 4, 5, 31, 32, 33, 63, 64, 65, 100, 130, 4095, 4096])
def test_cnn_kernels_match_plain(cuda, cnn_params, n_streams):
    params = cnn_step.prep_params({k: {n: t.to(cuda) for n, t in v.items()} for k, v in cnn_params.items()})
    rng = np.random.default_rng(n_streams)
    window = torch.from_numpy(rng.uniform(-2, 8, (76, 32, n_streams)).astype(np.float32)).to(cuda)
    before = (cnn_step_cuda.cnn_prime.launches["fp32"], cnn_step_cuda.cnn_step.launches["fp32"])
    emb, caches = cnn_step_cuda.cnn_prime(params, window)
    want_emb, want_caches = cnn_step_cuda.cnn_prime_plain(params, window)
    for _ in range(4):
        torch.cuda.synchronize()
        assert float((emb - want_emb).abs().max()) <= 1e-4
        assert max(float((a - b).abs().max()) for a, b in zip(caches, want_caches)) <= 1e-4
        new = torch.from_numpy(rng.uniform(-2, 8, (8, 32, n_streams)).astype(np.float32)).to(cuda)
        emb, caches = cnn_step_cuda.cnn_step(params, caches, new)
        want_emb, want_caches = cnn_step_cuda.cnn_step_plain(params, want_caches, new)
    torch.cuda.synchronize()
    assert float((emb - want_emb).abs().max()) <= 1e-4
    assert (cnn_step_cuda.cnn_prime.launches["fp32"], cnn_step_cuda.cnn_step.launches["fp32"]) == \
        (before[0] + 1, before[1] + 4)


def _cnn_prime_and_steps(params, window, steps):
    """The kernels' and the plain versions' embedding and caches after a
    prime and each of ``steps``."""
    emb, caches = cnn_step_cuda.cnn_prime(params, window)
    want_emb, want_caches = cnn_step_cuda.cnn_prime_plain(params, window)
    out = [(emb, caches, want_emb, want_caches)]
    for new in steps:
        emb, caches = cnn_step_cuda.cnn_step(params, caches, new)
        want_emb, want_caches = cnn_step_cuda.cnn_step_plain(params, want_caches, new)
        out.append((emb, caches, want_emb, want_caches))
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("n_streams", [37, 40])
def test_cnn_kernels_zero_stream_in_ragged_tile(cuda, cnn_params, n_streams):
    """The last stream, in the ragged last tile (5 or 8 of 32 streams; the
    4-byte and the 16-byte-copy variant), gets all-zero mel rows: it matches
    the plain version and the same stream run alone."""
    params = cnn_step.prep_params({k: {n: t.to(cuda) for n, t in v.items()} for k, v in cnn_params.items()})
    rng = np.random.default_rng(n_streams)
    window = torch.from_numpy(rng.uniform(-2, 8, (76, 32, n_streams)).astype(np.float32)).to(cuda)
    steps = [torch.from_numpy(rng.uniform(-2, 8, (8, 32, n_streams)).astype(np.float32)).to(cuda)
             for _ in range(4)]
    for x in [window] + steps:
        x[..., -1] = 0.0
    runs = _cnn_prime_and_steps(params, window, steps)
    alone = _cnn_prime_and_steps(params, window[..., -1:].contiguous(), [x[..., -1:].contiguous() for x in steps])
    for (emb, caches, want_emb, want_caches), (one_emb, one_caches, _, _) in zip(runs, alone):
        assert float((emb - want_emb).abs().max()) <= 1e-4
        assert max(float((a - b).abs().max()) for a, b in zip(caches, want_caches)) <= 1e-4
        assert float((emb[:, -1:] - one_emb).abs().max()) <= 1e-4
        assert max(float((a[..., -1:] - b).abs().max()) for a, b in zip(caches, one_caches)) <= 1e-4


def test_cnn_kernels_take_misaligned_rows(cuda, cnn_params):
    """S = 8 allows 16-byte copies, but mel rows whose storage starts one
    float into their buffer do not: the 4-byte variant runs and matches."""
    params = cnn_step.prep_params({k: {n: t.to(cuda) for n, t in v.items()} for k, v in cnn_params.items()})
    rng = np.random.default_rng(8)

    def misaligned(a):
        buf = torch.empty(a.size + 1, device=cuda)
        view = buf[1:].view(a.shape)
        view.copy_(torch.from_numpy(a))
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        return view
    window = misaligned(rng.uniform(-2, 8, (76, 32, 8)).astype(np.float32))
    steps = [misaligned(rng.uniform(-2, 8, (8, 32, 8)).astype(np.float32)) for _ in range(2)]
    for emb, caches, want_emb, want_caches in _cnn_prime_and_steps(params, window, steps):
        assert float((emb - want_emb).abs().max()) <= 1e-4
        assert max(float((a - b).abs().max()) for a, b in zip(caches, want_caches)) <= 1e-4


def _bf16_params(cnn_params, cuda):
    on_card = {k: {n: t.to(cuda) for n, t in v.items()} for k, v in cnn_params.items()}
    return cnn_step.prep_params(on_card, arith="1pass"), cnn_step.prep_params(on_card)


def _check_bf16_run(p16, p32, window, steps):
    """K4-bf16 on ``window``, then K3-bf16 on each of ``steps``, each call
    fed the plain version's caches, so kernel and plain see the same inputs;
    held against the plain bf16 version and the plain float32 one on those
    inputs (``assert_one_pass_close``), conv 1's output (``cache_2``, the
    second cache) ONE_PASS_CLOSER times nearer the plain bf16 version, and
    against itself on those inputs rounded beforehand
    (``assert_rounds_its_inputs``)."""
    got = cnn_step_cuda.cnn_prime(p16, window)
    want = cnn_step_cuda.cnn_prime_plain(p16, window)
    ref = cnn_step_cuda.cnn_prime_plain(p32, window)
    assert_rounds_its_inputs(got, lambda w: cnn_step_cuda.cnn_prime(p16, w), [window], "prime")
    for i in range(len(steps) + 1):
        torch.cuda.synchronize()
        assert torch.isfinite(got[0]).all()
        assert_one_pass_close(got[0], want[0], ref[0], f"emb {i}")
        for j, (a, b, c) in enumerate(zip(got[1], want[1], ref[1])):
            assert_one_pass_close(a, b, c, f"cache {j} after call {i}")
        assert_nearer(got[1][1], want[1][1], ref[1][1], f"cache_2 after call {i}", ONE_PASS_CLOSER)
        if i == len(steps):
            break
        caches = want[1]
        got = cnn_step_cuda.cnn_step(p16, caches, steps[i])
        want = cnn_step_cuda.cnn_step_plain(p16, caches, steps[i])
        ref = cnn_step_cuda.cnn_step_plain(p32, caches, steps[i])
        assert_rounds_its_inputs(got, lambda rows, *cs: cnn_step_cuda.cnn_step(p16, list(cs), rows),
                                 [steps[i], *caches], f"step {i + 1}")


# 4-byte copies (S = 1, 5, 33) and 16-byte ones (S = 100, a ragged tile, and 4096)
@pytest.mark.parametrize("n_streams", [1, 5, 33, 100, 4096])
def test_cnn_bf16_kernels_match_plain(cuda, cnn_params, n_streams):
    p16, p32 = _bf16_params(cnn_params, cuda)
    rng = np.random.default_rng(n_streams)
    window = torch.from_numpy(rng.uniform(-2, 8, (76, 32, n_streams)).astype(np.float32)).to(cuda)
    steps = [torch.from_numpy(rng.uniform(-2, 8, (8, 32, n_streams)).astype(np.float32)).to(cuda)
             for _ in range(3)]
    before = (cnn_step_cuda.cnn_prime.launches["1pass"], cnn_step_cuda.cnn_step.launches["1pass"])
    _check_bf16_run(p16, p32, window, steps)
    # each call twice: on its inputs and on them rounded beforehand
    assert (cnn_step_cuda.cnn_prime.launches["1pass"], cnn_step_cuda.cnn_step.launches["1pass"]) == \
        (before[0] + 2, before[1] + 6)


def test_cnn_bf16_kernels_take_misaligned_rows(cuda, cnn_params):
    """As test_cnn_kernels_take_misaligned_rows, for the bf16 variants: S = 8
    from views one float off 16-byte alignment run the 4-byte copies."""
    p16, p32 = _bf16_params(cnn_params, cuda)
    rng = np.random.default_rng(8)

    def misaligned(a):
        buf = torch.empty(a.size + 1, device=cuda)
        view = buf[1:].view(a.shape)
        view.copy_(torch.from_numpy(a))
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        return view
    window = misaligned(rng.uniform(-2, 8, (76, 32, 8)).astype(np.float32))
    steps = [misaligned(rng.uniform(-2, 8, (8, 32, 8)).astype(np.float32)) for _ in range(2)]
    _check_bf16_run(p16, p32, window, steps)


@pytest.mark.parametrize("n_streams", [21, 24])
def test_cnn_bf16_kernels_zero_stream_in_ragged_tile(cuda, cnn_params, n_streams):
    """As test_cnn_3pass_kernels_zero_stream_in_ragged_tile, for the 1-pass
    variants (the same 16-stream tiles): the last stream, in the ragged last
    tile (5 or 8 of 16 streams; the 4-byte and the 16-byte loads), gets
    all-zero mel rows. The run holds to the plain 1-pass version as
    ``_check_bf16_run`` does; and each call, fed the plain version's caches,
    gives the last stream what the same stream run alone on the same inputs
    gets, within 1e-4 + 2 E (``assert_one_pass_close``'s bound, E from the
    plain versions on that stream)."""
    p16, p32 = _bf16_params(cnn_params, cuda)
    rng = np.random.default_rng(n_streams)
    window = torch.from_numpy(rng.uniform(-2, 8, (76, 32, n_streams)).astype(np.float32)).to(cuda)
    steps = [torch.from_numpy(rng.uniform(-2, 8, (8, 32, n_streams)).astype(np.float32)).to(cuda)
             for _ in range(3)]
    for x in [window] + steps:
        x[..., -1] = 0.0
    _check_bf16_run(p16, p32, window, steps)

    def last(t):
        return t[..., -1:].contiguous()
    caches = None
    for x in [window] + steps:
        if caches is None:
            got, one = cnn_step_cuda.cnn_prime(p16, x), cnn_step_cuda.cnn_prime(p16, last(x))
            want, ref = cnn_step_cuda.cnn_prime_plain(p16, last(x)), cnn_step_cuda.cnn_prime_plain(p32, last(x))
            caches = cnn_step_cuda.cnn_prime_plain(p16, x)[1]
        else:
            alone = [last(c) for c in caches]
            got, one = cnn_step_cuda.cnn_step(p16, caches, x), cnn_step_cuda.cnn_step(p16, alone, last(x))
            want = cnn_step_cuda.cnn_step_plain(p16, alone, last(x))
            ref = cnn_step_cuda.cnn_step_plain(p32, alone, last(x))
            caches = cnn_step_cuda.cnn_step_plain(p16, caches, x)[1]
        torch.cuda.synchronize()
        for a, b, w, r in zip([got[0], *got[1]], [one[0], *one[1]], [want[0], *want[1]], [ref[0], *ref[1]]):
            e = float((w - r).abs().max())
            assert float((a[..., -1:] - b).abs().max()) <= 1e-4 + 2 * e


def _check_3pass_run(p3, p32, window, steps):
    """K4-high on ``window``, then K3-high on each of ``steps``, each call
    fed the plain version's caches: within 1e-4 of each tensor's scale of
    the plain 3-pass version, and conv 1's output (``cache_2``, the second
    cache) nearer it than the plain fp32 version's."""
    got = cnn_step_cuda.cnn_prime(p3, window)
    want = cnn_step_cuda.cnn_prime_plain(p3, window)
    ref = cnn_step_cuda.cnn_prime_plain(p32, window)
    for i in range(len(steps) + 1):
        torch.cuda.synchronize()
        assert torch.isfinite(got[0]).all()
        for j, (a, b) in enumerate(zip([got[0], *got[1]], [want[0], *want[1]])):
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), (i, j)
        assert_nearer(got[1][1], want[1][1], ref[1][1], f"cache_2 after call {i}")
        if i == len(steps):
            break
        caches = want[1]
        got = cnn_step_cuda.cnn_step(p3, caches, steps[i])
        want = cnn_step_cuda.cnn_step_plain(p3, caches, steps[i])
        ref = cnn_step_cuda.cnn_step_plain(p32, caches, steps[i])


# 4-byte loads (S % 4 != 0) and 16-byte ones, on both sides of the 16-stream
# block tile and of the FFMA kernels' 32-stream tile, and at 4096
@pytest.mark.parametrize("n_streams", [1, 5, 7, 8, 9, 15, 16, 17, 33, 63, 64, 65, 100, 127, 128, 129, 4096])
def test_cnn_3pass_kernels_match_plain(cuda, cnn_params, n_streams):
    on_card = {k: {n: t.to(cuda) for n, t in v.items()} for k, v in cnn_params.items()}
    p3, p32 = cnn_step.prep_params(on_card, arith="3pass"), cnn_step.prep_params(on_card)
    rng = np.random.default_rng(n_streams)
    window = torch.from_numpy(rng.uniform(-2, 8, (76, 32, n_streams)).astype(np.float32)).to(cuda)
    steps = [torch.from_numpy(rng.uniform(-2, 8, (8, 32, n_streams)).astype(np.float32)).to(cuda)
             for _ in range(3)]
    before = (cnn_step_cuda.cnn_prime.launches["3pass"], cnn_step_cuda.cnn_step.launches["3pass"])
    _check_3pass_run(p3, p32, window, steps)
    assert (cnn_step_cuda.cnn_prime.launches["3pass"], cnn_step_cuda.cnn_step.launches["3pass"]) == \
        (before[0] + 1, before[1] + 3)


def test_cnn_3pass_kernels_take_misaligned_rows(cuda, cnn_params):
    """As test_cnn_kernels_take_misaligned_rows, for the 3-pass variants."""
    on_card = {k: {n: t.to(cuda) for n, t in v.items()} for k, v in cnn_params.items()}
    rng = np.random.default_rng(8)

    def misaligned(a):
        buf = torch.empty(a.size + 1, device=cuda)
        view = buf[1:].view(a.shape)
        view.copy_(torch.from_numpy(a))
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        return view
    window = misaligned(rng.uniform(-2, 8, (76, 32, 8)).astype(np.float32))
    steps = [misaligned(rng.uniform(-2, 8, (8, 32, 8)).astype(np.float32)) for _ in range(2)]
    _check_3pass_run(cnn_step.prep_params(on_card, arith="3pass"), cnn_step.prep_params(on_card), window, steps)


@pytest.mark.parametrize("n_streams", [21, 24])
def test_cnn_3pass_kernels_zero_stream_in_ragged_tile(cuda, cnn_params, n_streams):
    """As test_cnn_kernels_zero_stream_in_ragged_tile, for the 3-pass
    variants, whose block tile is 16 streams: the last stream, in the ragged
    last tile (5 or 8 of 16 streams; the 4-byte and the 16-byte loads), gets
    all-zero mel rows. The run holds to the plain 3-pass version as
    ``_check_3pass_run`` does, and the last stream to the same stream run
    alone, within 1e-4 of each tensor's scale."""
    on_card = {k: {n: t.to(cuda) for n, t in v.items()} for k, v in cnn_params.items()}
    p3, p32 = cnn_step.prep_params(on_card, arith="3pass"), cnn_step.prep_params(on_card)
    rng = np.random.default_rng(n_streams)
    window = torch.from_numpy(rng.uniform(-2, 8, (76, 32, n_streams)).astype(np.float32)).to(cuda)
    steps = [torch.from_numpy(rng.uniform(-2, 8, (8, 32, n_streams)).astype(np.float32)).to(cuda)
             for _ in range(3)]
    for x in [window] + steps:
        x[..., -1] = 0.0
    _check_3pass_run(p3, p32, window, steps)
    runs = _cnn_prime_and_steps(p3, window, steps)
    alone = _cnn_prime_and_steps(p3, window[..., -1:].contiguous(), [x[..., -1:].contiguous() for x in steps])
    for (emb, caches, _, want_caches), (one_emb, one_caches, _, _) in zip(runs, alone):
        assert float((emb[:, -1:] - one_emb).abs().max()) <= 1e-4 * float(one_emb.abs().max())
        for a, b in zip(caches, one_caches):
            assert float((a[..., -1:] - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-30)


def test_cnn_kernel_rejects_bad_inputs(cuda, cnn_params):
    params = cnn_step.prep_params({k: {n: t.to(cuda) for n, t in v.items()} for k, v in cnn_params.items()})
    emb, caches = cnn_step_cuda.cnn_prime(params, torch.zeros((76, 32, 3), device=cuda))
    with pytest.raises(ValueError):
        cnn_step_cuda.cnn_step(params, caches, torch.zeros((16, 32, 3), device=cuda))
    with pytest.raises(ValueError):
        cnn_step_cuda.cnn_step(params, caches[:-1], torch.zeros((8, 32, 3), device=cuda))
    with pytest.raises(TypeError):
        cnn_step_cuda.cnn_step(params, caches, torch.zeros((8, 32, 3), dtype=torch.float64, device=cuda))


# ---------------------------------------------------------------------------
# the serving slice on the card


@pytest.fixture(scope="module")
def serving_golden(tmp_path_factory):
    from openwakeword_tpu_torch import testing
    with np.load(testing.SERVING_FIXTURE) as z:
        fixture = {k: z[k] for k in z.files}
    inputs = testing.golden_inputs(int(fixture["seed"]))
    paths = testing.write_head_checkpoints(inputs["heads"], str(tmp_path_factory.mktemp("heads")))
    return fixture, inputs, paths


def test_host_scores_match_a_blocking_copy(cuda):
    from openwakeword_tpu_torch.parallel.engine import HostScores
    x = torch.randn((64, 11), device=cuda)
    pending = HostScores(x * 2.0)
    np.testing.assert_array_equal(pending.numpy(), (x * 2.0).cpu().numpy())


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_server_golden_on_card(cuda, serving_golden, mode):
    from openwakeword_tpu_torch import testing
    from openwakeword_tpu_torch.parallel import StreamServer
    fixture, inputs, paths = serving_golden
    server = StreamServer(wakeword_models=paths, capacity=testing.SERVER_CAPACITY,
                          threshold=testing.SERVER_THRESHOLD, queue_frames=testing.SERVER_QUEUE_FRAMES,
                          precision="highest", device=cuda,
                          embedding_params=convert.embedding_from_jax(inputs["embedding"]))
    before = melspec_cuda.melspectrogram_frames.launches["direct"]
    run = testing.run_server_golden(server, mode)
    assert melspec_cuda.melspectrogram_frames.launches["direct"] - before == testing.SERVER_TICKS
    np.testing.assert_array_equal(run["valid"], fixture["server_valid"])
    assert np.abs(run["scores"] - fixture["server_scores"]).max() < 1e-3


def test_model_golden_on_card(cuda, serving_golden):
    from openwakeword_tpu_torch import Model, testing
    fixture, inputs, paths = serving_golden
    model = Model(wakeword_models=paths, device=cuda,
                  embedding_params=convert.embedding_from_jax(inputs["embedding"]))
    before = melspec_cuda.melspectrogram_frames.launches["direct"]
    scores = testing.run_model_golden(model, testing.model_packets())
    assert melspec_cuda.melspectrogram_frames.launches["direct"] > before
    assert np.abs(scores - fixture["model_scores"]).max() < 1e-3


def test_ingest_library_builds():
    from openwakeword_tpu_torch.parallel import ingest
    assert ingest.warm()


# the gating add-ons on the card


@pytest.mark.parametrize("profile", ["spectral", "mmse"])
def test_loaded_engine_on_card_matches_cpu(cuda, profile):
    """The bench configuration at 'high' with suppression, the VAD and two
    folded verifiers, S = 64, on the card against the same engine on the
    CPU (the plain 3-pass mel): scores within 1e-3, leaving out the entries
    within 1e-3 of the verifier threshold (``testing.near_verifier_threshold``);
    K1-3pass launches once per step."""
    from openwakeword_tpu_torch import testing
    from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine
    S, T = 64, 20
    pcm = testing.voiced_frames(T, S, seed=21, share=0.5)
    kw = dict(n_streams=S, vad_threshold=0.5, enable_noise_suppression=True, noise_suppression_algorithm=profile,
              custom_verifier_models=testing.gating_verifiers(), custom_verifier_threshold=0.3)
    card = MultiStreamEngine(device=cuda, **kw)
    cpu = MultiStreamEngine(device="cpu", **kw)
    base = MultiStreamEngine(device="cpu", n_streams=S, enable_noise_suppression=True,
                             noise_suppression_algorithm=profile).predict_frames(pcm)
    launches = melspec_cuda.melspectrogram_frames.launches
    before = launches["direct_3pass"]
    got = card.predict_frames(pcm)
    assert launches["direct_3pass"] - before == T
    want = cpu.predict_frames(pcm)
    near = testing.near_verifier_threshold(base, card.labels, testing.GATING_VERIFIED, 0.3)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    assert np.abs(got - want)[~near].max() < 1e-3
    assert near.mean() < 0.01
    warm = got[5:]                                                          # past the warm-up zeroing
    assert (warm == 0).all(axis=-1).any() and (warm != 0).any()             # the gate closed and opened


@pytest.mark.parametrize("profile", ["spectral", "mmse"])
def test_torch_noise_suppression_on_card(cuda, profile):
    from openwakeword_tpu_torch.ns import TorchNoiseSuppression
    rng = np.random.default_rng(22)
    on_card = TorchNoiseSuppression(algorithm=profile, device=cuda)
    on_cpu = TorchNoiseSuppression(algorithm=profile, device="cpu")
    for n in (1280, 3333, 160, 4000):
        x = np.round((rng.random(n) * 2 - 1) * 8000).astype(np.int16)
        got, want = on_card.process_frames(x), on_cpu.process_frames(x)
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    for k, v in on_cpu._state.items():
        np.testing.assert_allclose(on_card._state[k].cpu().numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(v.abs().max()), err_msg=k)


# ---------------------------------------------------------------------------
# the student embedding and the ONNX import on the card


@pytest.mark.parametrize("precision,variant", [("highest", "direct"), ("fast", "direct_1pass")])
def test_student_engine_on_card_matches_cpu(cuda, precision, variant):
    """The bench heads on the student embedding, S = 64, on the card against
    the same engine on the CPU within 1e-3 (at 'fast' within 2 E, E the
    CPU's own 1-pass distance from its 'highest'); the mel kernel of the
    tier launches once per step."""
    from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine
    S, T = 64, 12
    pcm = np.random.default_rng(23).integers(-3000, 3000, (T, S, 1280), dtype=np.int16)
    kw = dict(n_streams=S, precision=precision, embedding="student")
    card = MultiStreamEngine(device=cuda, **kw)
    launches = melspec_cuda.melspectrogram_frames.launches
    before = launches[variant]
    got = card.predict_frames(pcm)
    assert launches[variant] - before == T
    want = MultiStreamEngine(device="cpu", **kw).predict_frames(pcm)
    limit = 1e-3
    if precision == "fast":
        exact = MultiStreamEngine(device="cpu", **dict(kw, precision="highest")).predict_frames(pcm)
        limit = max(limit, 2 * float(np.abs(want - exact).max()))
    assert np.isfinite(got).all() and np.abs(got - want).max() < limit


def test_onnx_fixtures_on_card_match_cpu(cuda):
    """The committed graphs (a dnn head, a conv graph head, its QDQ twin and
    the Silero-shaped program) on the card against the CPU within 1e-5."""
    import os
    from openwakeword_tpu_torch import testing
    from openwakeword_tpu_torch.io import loaders
    from openwakeword_tpu_torch.models import heads, silero
    inputs = testing.onnx_inputs()
    for key in ("head", "graph", "qdq"):
        _, params, _ = loaders.load_model_file(os.path.join(testing.ONNX_DIR, testing.ONNX_FILES[key]))
        outs = []
        for dev in (cuda, torch.device("cpu")):
            head = convert.head_from_jax(params, dev)
            meta = head.pop("__meta__")
            outs.append(heads.forward(head, torch.from_numpy(inputs["windows"]).to(dev), meta).cpu().numpy())
        np.testing.assert_allclose(outs[0], outs[1], atol=1e-5, rtol=0, err_msg=key)
    params, meta = loaders.load_vad(os.path.join(testing.ONNX_DIR, testing.ONNX_FILES["silero"]))
    prog = silero.from_meta(meta, params)
    runs = [testing.run_silero(prog.apply, convert.vad_from_jax(prog.params, dev), inputs["audio"],
                               lambda t: t.cpu().numpy(), lambda a, d=dev: torch.from_numpy(a).to(d))
            for dev in (cuda, torch.device("cpu"))]
    for a, b in zip(*runs):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the TFLite import on the card


def test_tflite_exact_int8_on_card_bit_equal_to_cpu(cuda):
    """Exact int8 execution on the card: ``testing.int8_programs``' one-op
    graphs (the whole integer set, a FULLY_CONNECTED accumulator past 2^24)
    on the same int8 inputs, and the committed int8 graph head on 64 windows
    (per sample under vmap), bit-equal to the CPU; the float graphs of the
    fixture within 1e-5."""
    import os
    from openwakeword_tpu_torch import testing
    from openwakeword_tpu_torch.io import loaders, tflite_graph
    from openwakeword_tpu_torch.models import heads
    for name, model, feeds in testing.int8_programs():
        prog = tflite_graph.TfliteProgram(model, quantized="exact")
        outs = []
        for dev in (cuda, torch.device("cpu")):
            params = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in prog.params.items()}
            got = prog.apply(params, {k: torch.from_numpy(v).to(dev) for k, v in feeds.items()})
            outs.append({k: v.cpu() for k, v in got.items()})
        for k in outs[1]:
            assert outs[0][k].dtype == outs[1][k].dtype and torch.equal(outs[0][k], outs[1][k]), (name, k)
    windows = np.random.default_rng(24).normal(0, 1.5, (64, 16, 96)).astype(np.float32)
    for key, mode in testing.TFLITE_GOLDEN_HEADS:
        _, params, _ = loaders.load_model_file(os.path.join(testing.TFLITE_DIR, testing.TFLITE_FILES[key]),
                                               quantized=mode)
        outs = []
        for dev in (cuda, torch.device("cpu")):
            head = convert.head_from_jax(params, dev)
            meta = head.pop("__meta__")
            outs.append(heads.forward(head, torch.from_numpy(windows).to(dev), meta).cpu().numpy())
        if mode == "exact":
            np.testing.assert_array_equal(outs[0], outs[1], err_msg=key)
        else:
            np.testing.assert_allclose(outs[0], outs[1], atol=1e-5, rtol=0, err_msg=f"{key} {mode}")


def test_mesh_engine_on_card_matches_unsharded(cuda):
    """The bench configuration at 'high' on a 2-entry mesh of the card
    (2 x cuda:0), S = 64: K1-3pass launches once per shard per step, and
    the scores of ``predict``, ``predict_packets`` and ``predict_frames``
    equal the unsharded engine's within 1e-5; a sharded snapshot loads into
    the unsharded engine."""
    import os
    import tempfile
    from openwakeword_tpu_torch.parallel import Mesh
    from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine
    S, T = 64, 6
    pcm = np.random.default_rng(25).integers(-3000, 3000, (T, S, 1280)).astype(np.int16)
    mesh = MultiStreamEngine(n_streams=S, mesh=Mesh([cuda, cuda]))
    whole = MultiStreamEngine(n_streams=S, device=cuda)
    launches = melspec_cuda.melspectrogram_frames.launches
    before = launches["direct_3pass"]
    got = np.stack([mesh.predict(pcm[t]) for t in range(T)])
    assert launches["direct_3pass"] - before == 2 * T
    want = np.stack([whole.predict(pcm[t]) for t in range(T)])
    assert np.abs(got - want).max() <= 1e-5
    ids = np.array([5, 40, 2, 63, -1] + [-1] * (S - 5), np.int64)
    assert np.abs(mesh.predict_packets(pcm[0], ids) - whole.predict_packets(pcm[0], ids)).max() <= 1e-5
    assert np.abs(mesh.predict_frames(pcm) - whole.predict_frames(pcm)).max() <= 1e-5
    path = os.path.join(tempfile.mkdtemp(), "state.npz")
    mesh.save_state(path)
    whole.load_state(path)
    assert np.abs(mesh.predict(pcm[0]) - whole.predict(pcm[0])).max() <= 1e-5


# ---------------------------------------------------------------------------
# the engine's CNN stage on K3-high / K4-high at 'high'


def _engine_pcm(frames, streams, seed):
    rng = np.random.default_rng(seed)
    amp = np.geomspace(200.0, 25000.0, streams)[None, :, None]
    return np.round((rng.random((frames, streams, 1280)) * 2 - 1) * amp).astype(np.int16)


def test_engine_cnn_kernel_launches_at_high(cuda, monkeypatch):
    """At 'high' the engine's CNN stage launches K3-high once per shard per
    steady step and K4-high once per prime block of PRIME_BLOCK_STREAMS
    streams per shard, unsharded and on a 2-entry mesh of the card."""
    from openwakeword_tpu_torch import config
    from openwakeword_tpu_torch.parallel import Mesh
    from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine
    monkeypatch.setattr(config, "PRIME_BLOCK_STREAMS", 16)
    S, T = 40, 5
    pcm = _engine_pcm(T, S, seed=27)
    for where, shards in ((dict(device=cuda), 1), (dict(mesh=Mesh([cuda, cuda])), 2)):
        e = MultiStreamEngine(wakeword_models=["alexa", "timer"], n_streams=S, **where)
        before = (cnn_step_cuda.cnn_prime.launches["3pass"], cnn_step_cuda.cnn_step.launches["3pass"])
        e.predict_frames(pcm)
        assert (cnn_step_cuda.cnn_prime.launches["3pass"] - before[0],
                cnn_step_cuda.cnn_step.launches["3pass"] - before[1]) == \
            (shards * math.ceil(S / shards / 16), shards * (T - 1)), shards
        assert e.prime_steps == shards


def test_engine_cnn_kernels_run_inside_the_cnn_spans(cuda):
    """What ``cnn_device_ms.stream`` and ``conv_ms.stream`` read, through the
    benchmark's own reduction of a profiler trace: at 'high' every
    ``conv_mma_kernel`` launch, 20 a prime and 20 a step, is launched inside
    ``oww/engine.prime`` / ``oww/engine.cnn``, and no convolution runs."""
    from perfbench import trace
    from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine
    S = 64
    pcm = _engine_pcm(4, S, seed=28)
    e = MultiStreamEngine(wakeword_models=["alexa", "timer"], n_streams=S, device=cuda)
    e.predict(pcm[0])
    e.predict(pcm[1])
    e.reset()
    torch.cuda.synchronize()
    with trace.profiler() as prof:
        with torch.profiler.record_function(trace.PREFIX + trace.WINDOW):
            e.predict(pcm[2])
            e.predict(pcm[3])
            torch.cuda.synchronize()
    t = trace.reduce(prof)
    mma = [op for op in t.ops if "conv_mma_kernel" in op.name]
    assert len(mma) == 40
    assert sum("oww/engine.prime" in op.launched_by for op in mma) == 20
    assert sum("oww/engine.cnn" in op.launched_by for op in mma) == 20
    convs = {"aten::convolution", "aten::_convolution", "aten::cudnn_convolution", "aten::conv2d"}
    assert not [op.name for op in t.ops if op.launched_by & convs]
    assert not [ev.name for ev in prof.events() if ev.name in convs]


def test_engine_on_the_cnn_kernels_matches_the_eager_cnn(cuda, monkeypatch):
    """30 steps at 'high' (a prime, steady and masked steps, a re-primed
    stream) on K3-high / K4-high against the same engine with the route
    forced off (the eager float32 CNN): scores within 1e-4, the caches in
    JAX's (S, 2, W, C) layout."""
    from openwakeword_tpu_torch.models import embedding_stream
    from openwakeword_tpu_torch.parallel import engine as engine_module
    S = 100
    pcm = _engine_pcm(30, S, seed=29)
    mask = np.random.default_rng(30).random((10, S)) < 0.7

    def run(e):
        out = [e.predict(pcm[t]) for t in range(10)]
        out += [e.predict_masked(pcm[10 + t], mask[t]) for t in range(10)]
        e.reset_stream(7)
        out += list(e.predict_frames(pcm[20:]))
        return np.stack(out), e.state["conv_caches"]

    def engine():
        return engine_module.MultiStreamEngine(wakeword_models=["alexa", "timer"], n_streams=S, device=cuda)

    routed = engine()
    assert routed._replicas[routed.device].cnn_kernel is not None
    before = cnn_step_cuda.cnn_step.launches["3pass"]
    got, caches = run(routed)
    assert cnn_step_cuda.cnn_step.launches["3pass"] - before == 28        # 30 steps less two primes
    monkeypatch.setattr(engine_module, "cnn_kernel_route", lambda *_: False)
    eager = engine()
    assert eager._replicas[eager.device].cnn_kernel is None
    want, want_caches = run(eager)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4
    for k, shape in embedding_stream.cache_shapes().items():
        assert tuple(caches[k].shape) == (S, *shape)
        scale = float(want_caches[k].abs().max())
        assert float((caches[k] - want_caches[k]).abs().max()) <= 1e-4 * max(scale, 1.0), k


def test_engine_holds_the_caches_in_the_kernels_layout(cuda, monkeypatch, tmp_path):
    """At 'high' on the card the shard holds each cache as (C, 2, W, S),
    hands K3-high those very tensors (the same ``data_ptr``) and holds the
    kernel's outputs as they are; ``state`` gives them in JAX's layout; a
    snapshot loads into an eager engine, which saves it back bit for bit,
    and a routed engine that loads that goes on bit for bit as the one that
    saved it."""
    from openwakeword_tpu_torch.models import embedding_stream
    from openwakeword_tpu_torch.parallel import engine as engine_module
    S = 100
    pcm = _engine_pcm(8, S, seed=31)
    passed = []
    real = cnn_step_cuda.cnn_step

    def step(params, caches, mel_t):
        emb, new = real(params, caches, mel_t)
        passed.append(([c.data_ptr() for c in caches], [c.data_ptr() for c in new]))
        return emb, new
    step.launches = real.launches           # the launcher counts in the module's ``cnn_step``
    monkeypatch.setattr(cnn_step_cuda, "cnn_step", step)

    def engine():
        return engine_module.MultiStreamEngine(wakeword_models=["alexa", "timer"], n_streams=S, device=cuda)
    routed = engine()
    names = [name for name, _ in routed._replicas[routed.device].cnn_kernel.cache_shapes]
    for t in range(4):
        held = [routed.shard_states[0]["conv_caches"][n].data_ptr() for n in names]
        routed.predict(pcm[t])
        if t:
            assert passed[-1][0] == held
            assert [routed.shard_states[0]["conv_caches"][n].data_ptr() for n in names] == passed[-1][1]
    assert len(passed) == 3
    public = routed.state["conv_caches"]
    for k, (two, w, c) in embedding_stream.cache_shapes().items():
        held = routed.shard_states[0]["conv_caches"][k]
        assert tuple(held.shape) == (c, two, w, S) and held.is_contiguous(), k
        assert torch.equal(public[k], held.permute(3, 1, 2, 0)), k
    first, back = str(tmp_path / "routed.npz"), str(tmp_path / "eager.npz")
    routed.save_state(first)
    monkeypatch.setattr(engine_module, "cnn_kernel_route", lambda *_: False)
    eager = engine()
    eager.load_state(first)
    eager.save_state(back)
    with np.load(first) as a, np.load(back) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    monkeypatch.undo()
    again = engine()
    again.load_state(back)
    np.testing.assert_array_equal(again.predict_frames(pcm[4:]), routed.predict_frames(pcm[4:]))
