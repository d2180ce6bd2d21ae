"""Native ``.npz`` checkpoint format, numpy only (counterpart of
``openwakeword_tpu.io.checkpoints``; files are interchangeable).

Layout:
    __meta__  : JSON string (kind, architecture metadata, class mapping, ...)
    p/<path>  : one array per params leaf, '/'-joined dict keys

Arrays are stored in the JAX package's layout (HWIO convs, (n_in, n_out)
linears); ``openwakeword_tpu_torch.convert`` turns them into the port's
tensors.
"""

import json
import os
from typing import Any, Dict, Tuple

import numpy as np

SUFFIX = ".npz"


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if k == "__meta__":
            continue
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(v)
    return tree


def save_checkpoint(path: str, kind: str, params: Dict, meta: Dict[str, Any] | None = None):
    """Write numpy params + metadata to a .npz checkpoint."""
    meta = dict(meta or {})
    meta["kind"] = kind
    if isinstance(params.get("__meta__"), dict):
        meta.setdefault("model", params["__meta__"])
    arrays = {f"p/{k}": v for k, v in _flatten(params).items()}
    arrays["__meta__"] = np.array(json.dumps(meta))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_checkpoint(path: str) -> Tuple[str, Dict, Dict]:
    """Read a checkpoint -> (kind, numpy params, meta). Restores '__meta__'
    on the params when the metadata carries architecture info."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        flat = {k[2:]: z[k] for k in z.files if k.startswith("p/")}
    params = _unflatten(flat)
    if "model" in meta:
        params["__meta__"] = dict(meta["model"])
    return meta.get("kind", "unknown"), params, meta
