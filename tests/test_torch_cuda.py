"""The port's CUDA kernel on the card: built from ``csrc/``, held against its
plain PyTorch version. Marked ``cuda``; skipped where no NVIDIA GPU is
present. Run on a GPU host with ``python -m pytest tests/test_torch_cuda.py -m cuda``."""

import numpy as np
import pytest
import torch

from openwakeword_tpu_torch.ops import melspec_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n_streams", [1, 5, 17, 1000])
def test_mel_kernel_matches_plain(cuda, n_streams):
    w = (np.random.default_rng(n_streams).uniform(-1, 1, (n_streams, 1760)) * 25000).astype(np.float32)
    w[n_streams // 2] = 0.0
    x = torch.from_numpy(w).to(cuda)
    before = melspec_cuda.melspectrogram_frames.launches
    got = melspec_cuda.melspectrogram_frames(x)
    want = melspec_cuda.melspectrogram_frames_plain(x)
    torch.cuda.synchronize()
    assert melspec_cuda.melspectrogram_frames.launches == before + 1
    assert got.shape == (n_streams, 8, 32)
    assert float((got - want).abs().max()) <= 2e-3
    assert float((got[n_streams // 2] + 100.0).abs().max()) <= 1e-4


def test_mel_kernel_rejects_bad_inputs(cuda):
    with pytest.raises(TypeError):
        melspec_cuda.melspectrogram_frames(torch.zeros((2, 1760), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        melspec_cuda.melspectrogram_frames(torch.zeros((2, 1761), device=cuda))
    with pytest.raises(ValueError):
        melspec_cuda.melspectrogram_frames(torch.zeros((1760, 2), device=cuda).t())
