"""The port's stream-minor CNN step (``ops.cnn_step``, kernels 3 and 4 with
their plain versions) against the JAX package: the layer plan, the cache
layout, the prepped params, ``embedding_stream.init_caches_t`` / ``step_t``
and ``CnnStepKernel`` against JAX's Pallas ``CnnStepKernel`` run in interpret
mode. On the CPU the port's kernels run their plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu.models import embedding as jax_embedding
from openwakeword_tpu.models import embedding_stream as jax_stream
from openwakeword_tpu.ops import cnn_pallas
from openwakeword_tpu_torch import convert
from openwakeword_tpu_torch.models import embedding, embedding_stream
from openwakeword_tpu_torch.ops import cnn_step, cnn_step_cuda
from openwakeword_tpu_torch.utils import cuda_build

ATOL = 1e-4   # the JAX CNN kernel tests' own tolerance (tests/test_cnn_pallas.py)
S_KERNEL = 64   # one 64-stream tile of the JAX kernel in interpret mode


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


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


def _mel(rng, *shape):
    return rng.uniform(-2.0, 8.0, shape).astype(np.float32)


def _assert_caches(got, want, transpose=None):
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        if transpose is not None:
            w = np.transpose(w, transpose)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=ATOL, err_msg=k)


def test_layer_plan_and_cache_shapes_match_jax():
    assert cnn_step._layer_plan() == cnn_pallas._layer_plan()
    assert cnn_step.cache_shapes() == cnn_pallas.cache_shapes()
    assert [s for _, s in cnn_step.cache_shapes()] == [
        (1, 2, 34), (24, 2, 32), (48, 2, 16), (48, 2, 16), (72, 2, 8), (72, 2, 8),
        (96, 2, 4), (96, 2, 4), (96, 2, 2), (96, 2, 2), (96, 2, 1)]


def test_conv_table_follows_the_plan():
    table = cnn_step.conv_table()
    assert len(table) == jax_embedding.n_convs() == 20
    assert table[0] == (3, 3, 1, 24, 1, 1, cnn_step.STEM)
    assert table[2] == (3, 1, 24, 24, 2, 2, cnn_step.LEAKY)
    assert table[6] == (3, 1, 48, 48, 1, 2, cnn_step.LEAKY)
    assert table[-1] == (3, 1, 96, 96, 1, 1, cnn_step.BIAS_ONLY)
    assert sum(kh > 1 for kh, *_ in table) == len(cnn_step.cache_shapes())


def test_generated_program_header_is_the_conv_table():
    """csrc/cnn_step.cu compiles in the table the build writes from the spec."""
    text = cuda_build.generated_headers()["cnn_program.h"]
    rows = [line.rstrip(",") for line in text.splitlines() if line.startswith("{")]
    assert [tuple(int(v) for v in row.strip("{}").split(",")) for row in rows] == cnn_step.conv_table()
    assert '#include "cnn_program.h"' in (cuda_build.CSRC / "cnn_step.cuh").read_text()


@pytest.mark.parametrize("conv", range(20))
def test_tile_constants_fit_the_kernel(conv):
    """Each conv's block tile, compiled into csrc/cnn_step.cu through the
    generated cnn_tiles.h, satisfies what the kernel assumes: channel groups
    of 8 divide Cout; the block is whole warps and has a thread for every
    input cell it stages; K slices are whole 16-byte weight rows; a thread's
    positions are whole pool windows, or (2x2 pool) half of one whose other
    half is held by the thread 8 lanes away in the same warp; the block fits
    227 KB of shared memory."""
    table = cnn_step.conv_table()
    tiles = cnn_step_cuda.conv_tiles(table)
    text = cuda_build.generated_headers()["cnn_tiles.h"]
    rows = [line.rstrip(",") for line in text.splitlines() if line.startswith("{")]
    assert [tuple(int(v) for v in row.strip("{}").split(",")) for row in rows] == [tuple(t) for t in tiles]
    for name, value in (("kStreamQuads", cnn_step_cuda.STREAM_QUADS),
                        ("kThreadChannels", cnn_step_cuda.THREAD_CHANNELS), ("kStages", cnn_step_cuda.STAGES)):
        assert f"constexpr int {name} = {value};" in text
    assert '#include "cnn_tiles.h"' in (cuda_build.CSRC / "cnn_step.cuh").read_text()

    spec, tile = table[conv], tiles[conv]
    kh, kw, cin, cout, ph, pw, _ = spec
    win = ph * pw
    per_group = cnn_step_cuda.STREAM_QUADS * tile.groups          # threads per channel group
    assert cout % cnn_step_cuda.THREAD_CHANNELS == 0
    threads = cout // cnn_step_cuda.THREAD_CHANNELS * per_group
    assert threads % 32 == 0 and threads <= 1024
    assert tile.per_thread in (1, 2)
    cells = per_group * tile.per_thread
    assert threads >= cells                                      # every cell has a thread that stages it
    assert tile.k_slice % 4 == 0                                 # 16-byte weight rows
    assert cin % 4 or (kh * kw * cin) % tile.k_slice == 0        # 16-byte weight copies stay inside K
    assert cnn_step_cuda.tile_smem_bytes(spec, tile) <= cnn_step_cuda.SMEM_LIMIT == 227 * 1024
    for rows_in, prime in ((cnn_step_cuda.STEP_ROWS, False), (cnn_step_cuda.WINDOW_ROWS, True)):
        assert cnn_step_cuda.conv_positions(table, rows_in, prime)[conv] % win == 0
    # the kernel's thread -> positions map: thread tn of a channel group holds
    # tile positions (tn // 8) * NC + j, numbered pool window by window
    npt = tile.groups * tile.per_thread
    assert npt % win == 0
    for tid in range(threads):
        tn = tid % per_group
        held = {(tn // cnn_step_cuda.STREAM_QUADS) * tile.per_thread + j for j in range(tile.per_thread)}
        if win == 4:
            partner = tid ^ cnn_step_cuda.STREAM_QUADS
            assert partner // 32 == tid // 32 and partner // per_group == tid // per_group
            tp = partner % per_group
            held |= {(tp // cnn_step_cuda.STREAM_QUADS) * tile.per_thread + j for j in range(tile.per_thread)}
        assert all(p // win * win + e in held for p in held for e in range(win)), (tid, held)


def test_prep_params_matches_jax(folded):
    want = cnn_pallas._prep_params(folded[0], np.float32)
    p = cnn_step.prep_params(folded[1])
    got = [t for pair in zip(p.taps, p.biases) for t in pair] + [p.scale, p.shift]
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7)
    for i, mat in enumerate(p.mats):
        np.testing.assert_allclose(mat.numpy(), np.asarray(jax_stream._weight_mat(folded[0][f"conv_{i}"]["w"])),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n_streams", [1, 5])
def test_init_caches_t_and_step_t_match_jax(folded, rng, n_streams):
    ring = _mel(rng, n_streams, 76, 32)
    j_caches, j_emb = jax_stream.init_caches_t(folded[0], jnp.asarray(ring))
    t_caches, t_emb = embedding_stream.init_caches_t(folded[1], torch.from_numpy(ring))
    np.testing.assert_allclose(t_emb.numpy(), np.asarray(j_emb), rtol=0, atol=ATOL)
    _assert_caches(t_caches, j_caches)
    for _ in range(2):
        new = _mel(rng, n_streams, 8, 32)
        j_caches, j_emb = jax_stream.step_t(folded[0], j_caches, jnp.asarray(new))
        t_caches, t_emb = embedding_stream.step_t(folded[1], t_caches, torch.from_numpy(new))
        assert t_emb.shape == (n_streams, 96)
        np.testing.assert_allclose(t_emb.numpy(), np.asarray(j_emb), rtol=0, atol=ATOL)
        _assert_caches(t_caches, j_caches)


def test_kernel_matches_jax_pallas_interpret(folded, rng):
    """prime and 4 steps against JAX's Pallas kernel (prime(use_pallas=True),
    step) in interpret mode."""
    jk = cnn_pallas.CnnStepKernel(folded[0], sb=S_KERNEL, precision="highest", interpret=True)
    tk = cnn_step.CnnStepKernel(folded[1], precision="highest")
    window = _mel(rng, 76, 32, S_KERNEL)
    j_caches, j_emb = jk.prime(jnp.asarray(window), use_pallas=True)
    t_caches, t_emb = tk.prime(torch.from_numpy(window))
    assert t_emb.shape == (96, S_KERNEL)
    np.testing.assert_allclose(t_emb.numpy(), np.asarray(j_emb), rtol=0, atol=ATOL)
    _assert_caches(t_caches, j_caches)
    for _ in range(4):
        new = _mel(rng, 8, 32, S_KERNEL)
        j_caches, j_emb = jk.step(j_caches, jnp.asarray(new))
        t_caches, t_emb = tk.step(t_caches, torch.from_numpy(new))
        np.testing.assert_allclose(t_emb.numpy(), np.asarray(j_emb), rtol=0, atol=ATOL)
        _assert_caches(t_caches, j_caches)


def test_ragged_streams_match_nhwc_step(folded, rng):
    """S = 5 (no tile divides it): the stream-minor kernel path against the
    engine's NHWC ``embedding_stream`` through the (3, 1, 2, 0) transpose,
    both float32 (a layout check, so at 'highest': 'high' is the 3-pass
    kernel)."""
    tk = cnn_step.CnnStepKernel(folded[1], precision="highest", device="cpu")
    ring = _mel(rng, 5, 76, 32)
    caches, emb = tk.prime(torch.from_numpy(np.transpose(ring, (1, 2, 0)).copy()))
    n_caches, n_emb = embedding_stream.init_caches(folded[1], torch.from_numpy(ring))
    np.testing.assert_allclose(emb.t().numpy(), n_emb.numpy(), rtol=0, atol=ATOL)
    _assert_caches(caches, n_caches, (3, 1, 2, 0))
    for _ in range(2):
        new = _mel(rng, 5, 8, 32)
        caches, emb = tk.step(caches, torch.from_numpy(np.transpose(new, (1, 2, 0)).copy()))
        n_caches, n_emb = embedding_stream.step(folded[1], n_caches, torch.from_numpy(new))
        np.testing.assert_allclose(emb.t().numpy(), n_emb.numpy(), rtol=0, atol=ATOL)
        _assert_caches(caches, n_caches, (3, 1, 2, 0))


def test_wrappers_take_plain_path_for_cpu_tensors(folded, rng):
    params = cnn_step.prep_params(folded[1])
    window = torch.from_numpy(_mel(rng, 76, 32, 3))
    new = torch.from_numpy(_mel(rng, 8, 32, 3))
    emb, caches = cnn_step_cuda.cnn_prime(params, window)
    want_emb, want_caches = cnn_step_cuda.cnn_prime_plain(params, window)
    torch.testing.assert_close(emb, want_emb, rtol=0, atol=0)
    emb, caches = cnn_step_cuda.cnn_step(params, caches, new)
    want_emb, _ = cnn_step_cuda.cnn_step_plain(params, want_caches, new)
    torch.testing.assert_close(emb, want_emb, rtol=0, atol=0)
    assert all(c.is_contiguous() for c in caches)
    assert not any(cnn_step_cuda.cnn_step.launches.values()) and not any(cnn_step_cuda.cnn_prime.launches.values())


@pytest.mark.parametrize("tf32", [False, True])
def test_plain_versions_run_fp32_and_restore_tf32(folded, rng, monkeypatch, tf32):
    """The plain CNN turns TF32 off for its own products and puts the
    caller's setting back."""
    seen = []
    matmul = torch.matmul

    def spy(*args, **kwargs):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return matmul(*args, **kwargs)

    monkeypatch.setattr(torch, "matmul", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", tf32)
    params = cnn_step.prep_params(folded[1])
    cnn_step_cuda.cnn_prime_plain(params, torch.from_numpy(_mel(rng, 76, 32, 2)))
    assert len(seen) == len(params.mats) and not any(seen)
    assert torch.backends.cuda.matmul.allow_tf32 is tf32


def test_wrappers_reject_other_devices(folded):
    params = cnn_step.prep_params(folded[1])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cnn_step_cuda.cnn_prime(params, torch.empty((76, 32, 2), device="meta"))


@pytest.mark.parametrize("precision", ["fast", "mixed", "tf32", {"cnn": "high"}])
def test_precisions_outside_the_kernel_raise(folded, precision):
    """The kernel takes the modes of JAX's ``_dot`` ('highest', 'high',
    'bf16'); the engine's other tiers and anything else raise ValueError
    (JAX's CnnStepKernel raises KeyError for 'fast' and 'mixed' at prime)."""
    with pytest.raises(ValueError, match="CnnStepKernel precision"):
        cnn_step.CnnStepKernel(folded[1], precision=precision)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_weight_dtypes(folded, dtype):
    """bf16 weights are taken (as float32, exactly) and give the 'bf16'
    params of their float32 originals; other dtypes raise."""
    cast = {k: {n: t.to(dtype) if n == "w" else t for n, t in v.items()} for k, v in folded[1].items()}
    if dtype == torch.float64:
        with pytest.raises(TypeError, match="float32 or bf16"):
            cnn_step.CnnStepKernel(cast)
        return
    got = cnn_step.CnnStepKernel(cast, precision="bf16").params
    want = cnn_step.CnnStepKernel(folded[1], precision="bf16").params
    assert got.arith == want.arith == "1pass"
    for a, b in zip(got.taps, want.taps):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(got.mats, want.mats):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=0)
