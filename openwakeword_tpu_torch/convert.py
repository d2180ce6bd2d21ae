"""Carry params from the JAX package's layout into the port's tensors.

The JAX package (and the shared ``.npz`` checkpoints) store embedding convs
as HWIO and head and student linears as (n_in, n_out), with a head's
architecture under ``"__meta__"``. The port runs convs as OIHW, so conv
weights are transposed; every other leaf keeps its shape. Leaves may be numpy arrays or
anything ``numpy.asarray`` accepts; nothing here imports jax.
"""

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def _tensor(v, device) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32, copy=True)).to(device)


def _tree(params: Mapping, device, leaf) -> Dict:
    return {k: (_tree(v, device, leaf) if isinstance(v, Mapping) else leaf(k, v, device))
            for k, v in params.items() if k != "__meta__"}


def embedding_from_jax(params: Mapping, device="cpu") -> Dict:
    """Embedding params (BN-folded or not) -> port tensors, HWIO -> OIHW."""
    def leaf(k, v, dev):
        a = np.asarray(v)
        return _tensor(np.transpose(a, (3, 2, 0, 1)) if k == "w" and a.ndim == 4 else a, dev)
    return _tree(params, device, leaf)


def _head_leaf(k, v, device) -> torch.Tensor:
    a = np.asarray(v)
    if np.issubdtype(a.dtype, np.integer):
        # an exact int8 graph head's weights: integer arithmetic, kept as stored
        return torch.from_numpy(np.array(a, copy=True)).to(device)
    return _tensor(a, device)


def head_from_jax(params: Mapping, device="cpu") -> Dict:
    """One head's params -> port tensors (float32, integer leaves in their
    own dtype); '__meta__' is kept as a plain dict of Python scalars."""
    out = _tree(params, device, _head_leaf)
    if "__meta__" in params:
        out["__meta__"] = {k: (v.item() if isinstance(v, np.generic) else v)
                           for k, v in dict(params["__meta__"]).items()}
    return out


def student_from_jax(params: Mapping, device="cpu") -> Dict:
    """Student embedding params (``models.embedding_student`` layout) ->
    port tensors, every leaf in its shape."""
    return _tree(params, device, lambda k, v, dev: _tensor(v, dev))


def vad_from_jax(params: Mapping, device="cpu") -> Dict:
    """VAD network params (``models.vad_net`` layout) -> port tensors, every
    leaf in its shape."""
    return _tree(params, device, lambda k, v, dev: _tensor(v, dev))


def trainer_from_jax(params: Mapping, opt_state, device="cpu") -> Tuple[Dict, Dict]:
    """A JAX ``HeadTrainer``'s params and optimizer state -> the port
    trainer's (``training.trainer.HeadTrainer.params`` and ``.opt_state``),
    so both trainers start from the same point.

    The JAX trainer's optimizer is ``optax.chain(optax.scale_by_adam(),
    optax.scale(-1.0))``. Its state is a tuple with one entry per link of
    the chain: the first a ``ScaleByAdamState`` namedtuple of ``count``
    (int32 scalar, the updates applied so far), ``mu`` and ``nu`` (the first
    and second moments, trees shaped as the params without ``"__meta__"``),
    the second ``scale``'s empty state. The fields are read by attribute (or
    key), so optax need not be importable. Returns (the head's params as
    ``head_from_jax`` gives them, {"count": int32 tensor, "mu": tree, "nu":
    tree} of float32 tensors), all on ``device``."""
    adam = opt_state[0] if isinstance(opt_state, (tuple, list)) else opt_state

    def field(name):
        return adam[name] if isinstance(adam, Mapping) else getattr(adam, name)

    moments = {name: _tree(field(name), device, lambda k, v, dev: _tensor(v, dev)) for name in ("mu", "nu")}
    count = torch.tensor(int(np.asarray(field("count"))), dtype=torch.int32, device=device)
    return head_from_jax(params, device), {"count": count, **moments}


def to_device(tree, device):
    """A nested dict of tensors, moved to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def from_jax_params(embedding_params: Optional[Mapping] = None,
                    head_params: Optional[Mapping[str, Mapping]] = None,
                    device="cpu") -> Tuple[Optional[Dict], Optional[Dict]]:
    """(embedding params, {name: head params}) in the JAX layout -> the
    port's tensors on ``device``; either side may be None."""
    emb = None if embedding_params is None else embedding_from_jax(embedding_params, device)
    heads = None if head_params is None else {n: head_from_jax(p, device) for n, p in head_params.items()}
    return emb, heads
