"""Classifier-head trainer in PyTorch (counterpart of
``openwakeword_tpu.training.trainer``), with the JAX package's training
semantics step for step.

Reference behaviours kept (reference train.py:25-366, 434-570):
  * warmup -> hold -> cosine LR schedule (train.py:167-190);
  * online hard-example selection, by masking: negatives with pred >= 0.001
    and positives with pred < 0.999 (train.py:463-468);
  * the negative-weight schedule 1 -> max_negative_weight (train.py:470-481);
  * the accumulate-until-128 update gate with the ``acc_steps`` divisor
    (train.py:483-500), zero-survivor batches as no-ops, and the optional
    true gradient accumulation (``true_accumulation``);
  * periodic validation, checkpoint snapshots when val FP <= median and
    recall >= 5th percentile, and ``auto_train``'s three sequences with
    negative-weight doubling and percentile-filtered weight averaging
    (train.py:261-366; the best val FP/hr is tracked, as in the JAX package).

The optimizer is the JAX package's scale-free Adam (optax ``scale_by_adam``:
b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias-corrected, its
count advanced only on an update), then multiplied by -lr. During training
the params, both moments and the gradient are flat float32 vectors on
``device``; the heads' own ``models.heads.forward(..., inference=False)``
reads the params through views of theirs, and autograd differentiates the
loss by the params vector. The update gate is decided on the device: the
update, the Adam state and the accumulators pass through ``torch.where``,
and the schedule is copied once per run, so no step reads the device or
waits for it. Between calls the params are numpy in the checkpoint (JAX)
layout with their ``__meta__``, as the JAX trainer keeps them.
"""

import itertools
import logging
import os
import pickle
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from openwakeword_tpu_torch.models import heads as heads_lib
from openwakeword_tpu_torch.parallel.mesh import Mesh, put_sharded

B1, B2, EPS = 0.9, 0.999, 1e-8
_INT32_MAX = 2 ** 31 - 1


def lr_warmup_cosine_decay(global_step, warmup_steps=0, hold=0, total_steps=0,
                           start_lr=0.0, target_lr=1e-3):
    """Warmup -> hold -> cosine decay (reference train.py:167-190)."""
    learning_rate = 0.5 * target_lr * (1 + np.cos(np.pi * (global_step - warmup_steps - hold)
                                                  / float(total_steps - warmup_steps - hold)))
    warmup_lr = target_lr * (global_step / max(warmup_steps, 1))
    if hold > 0:
        learning_rate = np.where(global_step > warmup_steps + hold, learning_rate, target_lr)
    learning_rate = np.where(global_step < warmup_steps, warmup_lr, learning_rate)
    return float(learning_rate)


# ---------------------------------------------------------------------------
# Params as flat dicts of tensors
# ---------------------------------------------------------------------------

def _flatten(tree: Dict, prefix: str = "") -> Dict:
    out = {}
    for k, v in tree.items():
        if k == "__meta__":
            continue
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflatten(flat: Dict) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _tensors(tree: Dict, device) -> Dict:
    """A params tree (numpy or tensors, '__meta__' dropped) -> a flat dict of
    float32 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                               dtype=torch.float32).to(device)
            for k, v in _flatten(tree).items()}


def _numpy(flat: Dict) -> Dict:
    """A flat dict of tensors -> a numpy tree."""
    return _unflatten({k: v.detach().cpu().numpy() for k, v in flat.items()})


def init_adam(params: Dict) -> Dict:
    """The Adam state of a flat params dict: count 0, zero moments."""
    first = next(iter(params.values()))
    return {"count": torch.zeros((), dtype=torch.int32, device=first.device),
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def _adam_state_to(opt: Dict, device) -> Dict:
    """An Adam state (nested or flat moments, numpy or tensors) as flat
    tensors on ``device``."""
    return {"count": torch.as_tensor(np.asarray(opt["count"]) if not isinstance(opt["count"], torch.Tensor)
                                     else opt["count"], dtype=torch.int32).to(device),
            "mu": _tensors(opt["mu"], device), "nu": _tensors(opt["nu"], device)}


class _Layout:
    """Where each leaf of a head's params sits in one flat float32 vector:
    training keeps the params, both Adam moments and the gradient as such
    vectors, so an update is a few elementwise passes whatever the number of
    leaves, and the forward reads views of the vector."""

    def __init__(self, tree: Dict):
        flat = _flatten(tree)
        self.keys = list(flat)
        self.shapes = [tuple(np.shape(v)) for v in flat.values()]
        self.sizes = [int(np.prod(s)) for s in self.shapes]

    def pack(self, tree: Dict, device) -> torch.Tensor:
        """A tree (or a flat dict) of this layout -> its vector on ``device``."""
        flat = _tensors(tree, device)
        return torch.cat([flat[k].reshape(-1) for k in self.keys])

    def views(self, vec: torch.Tensor) -> Dict:
        """The flat dict of leaves viewing ``vec``."""
        return {k: v.view(s) for k, v, s in zip(self.keys, vec.split(self.sizes), self.shapes)}


# ---------------------------------------------------------------------------
# One training step
# ---------------------------------------------------------------------------

def _loss_terms(params: Dict, x: torch.Tensor, y: torch.Tensor, neg_weight: torch.Tensor, meta: Dict):
    """The masked hard-example loss before its division by the survivor
    count -> (sum of the weighted per-example losses, survivor mask)."""
    out = heads_lib.forward(_unflatten(params), x, meta, inference=False)
    if meta["n_classes"] == 1:
        probs = out[:, 0]
        mask = torch.where(y == 0, probs >= 0.001, probs < 0.999)
        w = torch.where(y == 1, torch.ones_like(neg_weight), neg_weight) * mask
        eps = 1e-7
        # minimum(maximum(.)) as jnp.clip, whose ties split the gradient
        probs_c = torch.minimum(torch.maximum(probs, torch.full_like(probs, eps)), torch.full_like(probs, 1 - eps))
        bce = -(y * torch.log(probs_c) + (1 - y) * torch.log(1 - probs_c))
        return (w * bce).sum(), mask
    probs = torch.softmax(out, dim=-1)
    rows = torch.arange(y.shape[0], device=y.device)
    yi = y.to(torch.int64)
    conf = probs.amax(dim=-1)
    correct_conf = probs[rows, yi]
    mask = torch.where(y == 0, conf >= 0.001, correct_conf < 0.999)
    w = torch.where(y != 0, torch.ones_like(neg_weight), neg_weight) * mask
    ce = -torch.log_softmax(out, dim=-1)[rows, yi]
    return (w * ce).sum(), mask


def _train_step(params: torch.Tensor, opt: Dict, acc: Dict, x: torch.Tensor, y: torch.Tensor,
                neg_weight: torch.Tensor, lr: torch.Tensor, meta: Dict, layout: _Layout,
                accum_target: int = 128, true_acc: bool = False):
    """One step with masked hard-example selection and the reference's
    accumulate-until-128 update gate (JAX ``trainer._step_impl``).

    ``params`` is the flat vector of ``layout``, ``opt`` the Adam state
    (``count``, and ``mu`` and ``nu`` as vectors); ``acc`` carries ``n_acc``
    and ``acc_steps`` (int32 scalars; plus the vector ``grad_sum`` with
    ``true_acc``). ``true_acc=False`` reproduces the reference: only the
    batch that crosses the gate contributes its gradient, scaled by
    1/acc_steps; ``true_acc=True`` sums the window's gradients and applies
    their mean. Returns (params', opt', acc', stats), every value a tensor
    on the device.

    Data parallel: ``params`` a tuple of replicas of the vector and ``x``,
    ``y`` tuples of as many batch shards, each on its replica's device. Every
    shard's forward runs first; the survivor count is the global one, each
    shard divides its own loss sum by it, and the shards' gradients add up
    on the first replica's device, where ``opt`` and ``acc`` live and the
    update is made (the single-device math, summed in another order); the
    new vector is copied to the other replicas, returned as a tuple."""
    sharded = not isinstance(params, torch.Tensor)
    replicas, xs, ys = (tuple(params), tuple(x), tuple(y)) if sharded else ((params,), (x,), (y,))
    dev = replicas[0].device
    leaves = [p.detach().requires_grad_(True) for p in replicas]
    # a bf16 feed is cast back before any math
    terms = [_loss_terms(layout.views(leaf), xk.to(torch.float32), yk.to(torch.float32),
                         neg_weight.to(leaf.device), meta)
             for leaf, xk, yk in zip(leaves, xs, ys)]
    n_survivors = torch.stack([mask.sum().to(dev) for _, mask in terms]).sum().to(torch.int32)
    n_sel = torch.clamp(n_survivors.to(torch.float32), min=1.0)
    grad = loss = None
    for leaf, (total, _) in zip(leaves, terms):
        part = total / n_sel.to(leaf.device)
        g, = torch.autograd.grad(part, leaf)
        grad = g.to(dev) if grad is None else grad + g.to(dev)
        loss = part.detach().to(dev) if loss is None else loss + part.detach().to(dev)
    with torch.no_grad():
        # zero-survivor batches neither update nor count toward the divisor
        nonzero = n_survivors > 0
        do_update = ((acc["n_acc"] + n_survivors) >= accum_target) & nonzero
        if true_acc:
            grad = acc["grad_sum"] + grad
        count = torch.where(opt["count"] < _INT32_MAX, opt["count"] + 1, opt["count"])
        g = grad / acc["acc_steps"].to(torch.float32)
        m = (1 - B1) * g + B1 * opt["mu"]
        v = (1 - B2) * (g ** 2) + B2 * opt["nu"]
        update = (m / (1 - B1 ** count.to(torch.float32))) / (
            torch.sqrt(v / (1 - B2 ** count.to(torch.float32))) + EPS) * -1.0 * lr
        new_params = torch.where(do_update, replicas[0] + update, replicas[0])
        new_opt = {"count": torch.where(do_update, count, opt["count"]),
                   "mu": torch.where(do_update, m, opt["mu"]), "nu": torch.where(do_update, v, opt["nu"])}
        new_acc = {"n_acc": torch.where(do_update, torch.zeros_like(acc["n_acc"]), acc["n_acc"] + n_survivors),
                   "acc_steps": torch.where(do_update, torch.ones_like(acc["acc_steps"]),
                                            acc["acc_steps"] + nonzero.to(torch.int32))}
        if true_acc:
            new_acc["grad_sum"] = torch.where(do_update, torch.zeros_like(grad), grad)
    stats = {"loss": loss, "n_survivors": n_survivors, "updated": do_update}
    if sharded:
        copies = {dev: new_params}
        for p in replicas:
            if p.device not in copies:
                copies[p.device] = new_params.to(p.device)
        new_params = tuple(copies[p.device] for p in replicas)
    return new_params, new_opt, new_acc, stats


def _binary_fp(preds, y):
    # reference: (y - pred <= -0.5).sum() (train.py:100)
    return int(np.sum((y - preds) <= -0.5))


def _binary_recall(preds, y, threshold=0.5):
    tp = np.sum((preds >= threshold) & (y == 1))
    fn = np.sum((preds < threshold) & (y == 1))
    return float(tp / max(tp + fn, 1))


def _binary_accuracy(preds, y, threshold=0.5):
    return float(np.mean((preds >= threshold) == (y == 1)))


class HeadTrainer:
    """Trains one wake-word classifier head (the reference's torch Model
    class; the JAX package's ``HeadTrainer``). Data enters as numpy (batch,
    frames, 96) feature windows with integer labels. ``device`` defaults to
    "cuda" and raises without CUDA; "cpu" trains on the host. ``mesh``
    (``parallel.mesh.Mesh``, wholly owned by this process) takes the place
    of ``device`` for data-parallel training (``shard``)."""

    def __init__(self, n_classes: int = 1, input_shape=(16, 96), model_type: str = "dnn",
                 layer_dim: int = 128, n_blocks: int = 1, seconds_per_example=None,
                 seed: int = 0, mesh=None, device=None):
        if mesh is not None and device is not None:
            raise ValueError("pass either a mesh or a device: the mesh names the devices")
        self.shard(mesh if mesh is not None else Mesh([device or "cuda"]))
        self.mesh = mesh              # None unsharded, as in the JAX trainer
        # float32 products, as the JAX heads' Precision.HIGHEST
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.n_classes = n_classes
        self.input_shape = tuple(input_shape)
        self.seconds_per_example = seconds_per_example
        # drawn from numpy, as models.heads.init_params; nothing from torch's RNG
        self.params = heads_lib.init_params(
            np.random.default_rng(seed), model_type=model_type, input_frames=input_shape[0],
            n_classes=n_classes, layer_dim=layer_dim, n_blocks=n_blocks)
        self.meta = dict(self.params["__meta__"])
        self.opt_state = init_adam(_tensors(self.params, self.device))

        self.history: Dict[str, list] = defaultdict(list)
        self.best_models: List[Dict] = []
        self.best_model_scores: List[Dict] = []
        self.best_val_fp = 1000.0
        self.best_val_accuracy = 0.0
        self.best_val_recall = 0.0
        self.n_fp = 0

    def shard(self, mesh):
        """Train data-parallel over a 1-D mesh: ``train_model`` keeps a
        replica of the params vector per distinct device and splits each
        batch over the entries (an entry may repeat a device); the gradients
        add up on the first entry's device, which keeps the Adam state and
        makes the update (``_train_step``). Batch sizes must be divisible by
        the mesh size. A mesh entry of another process raises: there is no
        process group to add gradients across processes."""
        if len(mesh.owned) != mesh.size:
            raise ValueError(f"HeadTrainer needs a mesh wholly owned by this process; got {mesh}")
        for dev in set(mesh.devices):
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"HeadTrainer(device='{dev}') needs a CUDA device; pass device='cpu' to "
                                   "train on the host")
        self._layout = mesh
        self.mesh = mesh
        self.device = mesh.devices[0]

    def _leaf(self, params: Dict) -> Dict:
        return {k: v for k, v in params.items() if k != "__meta__"}

    def _staged(self, shape, dtype) -> torch.Tensor:
        """A host buffer for a copy to the device: pinned for a CUDA device
        (PyTorch's host allocator hands it out again only once the copy
        that read it has finished), so the copy does not wait for the card."""
        return torch.empty(shape, dtype=dtype, pin_memory=self.device.type == "cuda")

    def _device_chunk(self, group, dtype=None):
        """K same-shape (x, y) batches stacked into (K, batch, ...) tensors
        in one host->device copy per mesh entry, each entry's share of the
        batch axis on its device; ``dtype`` narrows the x transfer. Returns
        (x parts, y parts), one per entry."""
        n = np.shape(group[0][0])[0]
        if n % self._layout.size:
            raise ValueError(f"batch size {n} must be divisible by the {self._layout.size}-device mesh "
                             "for data-parallel training")
        xs = self._staged((len(group),) + np.shape(group[0][0]), dtype or torch.float32)
        ys = self._staged((len(group),) + np.shape(group[0][1]), torch.float32)
        for k, (x, y) in enumerate(group):
            xs[k].copy_(torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)))
            ys[k].copy_(torch.from_numpy(np.asarray(y, np.float32)))
        return (put_sharded(xs, self._layout, axis=1, non_blocking=True),
                put_sharded(ys, self._layout, axis=1, non_blocking=True))

    def _device_batch(self, x, y, dtype=None):
        """One (x, y) batch to the device(s), split over the mesh entries;
        ``dtype`` narrows the x transfer (the step casts back to float32
        before any math)."""
        xs, ys = self._device_chunk([(x, y)], dtype)
        return [p[0] for p in xs], [p[0] for p in ys]

    # -- core API -----------------------------------------------------

    def forward(self, x, params=None) -> np.ndarray:
        p = _unflatten(_tensors(params or self.params, self.device))
        xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(self.device)
        with torch.no_grad():
            return heads_lib.forward(p, xt, self.meta, inference=True).cpu().numpy()

    def fp(self, preds, y):
        preds = np.asarray(preds).reshape(len(preds), -1)
        y = np.asarray(y)
        if self.n_classes == 1:
            return _binary_fp(preds[:, 0], y.reshape(-1))
        neg = y == 0
        return int(np.sum((np.argmax(preds[neg], axis=1) != 0)
                          & (np.max(preds[neg], axis=1) > 0.5)))

    def recall(self, preds, y):
        preds = np.asarray(preds).reshape(len(preds), -1)
        y = np.asarray(y).reshape(-1)
        if self.n_classes == 1:
            return _binary_recall(preds[:, 0], y)
        pos = y != 0
        if pos.sum() == 0:
            return 0.0
        return float(np.sum((np.argmax(preds[pos], axis=1) > 0)
                            & (np.max(preds[pos], axis=1) >= 0.5)) / pos.sum())

    def accuracy(self, preds, y):
        preds = np.asarray(preds).reshape(len(preds), -1)
        y = np.asarray(y).reshape(-1)
        if self.n_classes == 1:
            return _binary_accuracy(preds[:, 0], y)
        pred_pos = np.argmax(preds, axis=1) != 0
        if pred_pos.sum() == 0:
            return 0.0
        return float(np.sum(np.argmax(preds[pred_pos], axis=1) == y[pred_pos]) / pred_pos.sum())

    # -- training loop --------------------------------------------------

    def train_model(self, X: Iterable, max_steps: int, warmup_steps: int, hold_steps: int,
                    X_val=None, false_positive_val_data=None, positive_test_clips=None,
                    negative_weight_schedule=(1,), val_steps=(250,), lr: float = 1e-4,
                    val_set_hrs: float = 1.0, true_accumulation: bool = False,
                    feed_chunk: int = 32, feed_dtype=None):
        """Train over an iterable of (x, y) numpy batches (reference
        train.py:434-570 semantics; see the module docstring).

        ``feed_chunk``: consecutive same-shape batches stacked into one
        host->device copy, then stepped one by one on the device, with the
        same numerics as the per-step path; chunks end at validation
        boundaries, so validation happens at the same step indices. 1 copies
        every batch on its own.

        ``feed_dtype``: a narrow torch dtype (``torch.bfloat16``) for the
        host->device copy only; the step casts back to float32 before any
        math."""
        val_steps = set(int(v) for v in np.asarray(val_steps).tolist())

        # validation inputs are iterated once per validation round
        def _reiterable(d):
            return d if d is None or isinstance(d, (list, tuple)) else list(d)
        X_val = _reiterable(X_val)
        false_positive_val_data = _reiterable(false_positive_val_data)
        positive_test_clips = _reiterable(positive_test_clips)
        dev = self.device
        layout = _Layout(self.params)
        params = layout.pack(self.params, dev)
        # one replica per distinct device of the mesh, the first on dev
        replica_of = {dev: params}
        for d in self._layout.devices:
            if d not in replica_of:
                replica_of[d] = params.to(d)
        replicas = tuple(replica_of[d] for d in self._layout.devices)
        opt = _adam_state_to(self.opt_state, dev)
        opt_state = {"count": opt["count"], "mu": layout.pack(opt["mu"], dev), "nu": layout.pack(opt["nu"], dev)}
        acc = {"n_acc": torch.zeros((), dtype=torch.int32, device=dev),
               "acc_steps": torch.ones((), dtype=torch.int32, device=dev)}
        if true_accumulation:
            acc["grad_sum"] = torch.zeros_like(params)
        meta = self.meta

        pending_stats: list = []

        def flush_stats():
            if not pending_stats:
                return
            updated = torch.stack([s["updated"] for s in pending_stats]).cpu().numpy()
            losses = torch.stack([s["loss"] for s in pending_stats]).cpu().numpy()
            self.history["loss"].extend(float(l) for u, l in zip(updated, losses) if u)
            pending_stats.clear()

        def schedule(s):
            step_lr = lr_warmup_cosine_decay(s, warmup_steps=warmup_steps,
                                             hold=hold_steps, total_steps=max_steps,
                                             target_lr=lr)
            if len(negative_weight_schedule) == 1:
                neg_w = float(negative_weight_schedule[0])
            else:
                neg_w = float(negative_weight_schedule[
                    min(s, len(negative_weight_schedule) - 1)])
            return step_lr, neg_w

        # the whole run's learning rates and negative weights, copied once
        sched_all = [schedule(s) for s in range(max_steps)]
        lrs = torch.tensor([s[0] for s in sched_all], dtype=torch.float32).to(dev)
        neg_ws = torch.tensor([s[1] for s in sched_all], dtype=torch.float32).to(dev)

        def live():
            return {"__meta__": meta, **_unflatten(layout.views(params))}

        source = iter(X)
        step_ndx = -1
        exhausted = False
        while not exhausted and step_ndx < max_steps - 1:
            s0 = step_ndx + 1
            # a chunk ends exactly at the next validation boundary
            upcoming = [v for v in val_steps if v >= s0]
            stop = min(min(upcoming) + 1 if upcoming else max_steps, max_steps)
            k_target = max(1, min(feed_chunk, stop - s0))
            group = list(itertools.islice(source, k_target))
            if not group:
                break
            exhausted = len(group) < k_target

            uniform = len(group) > 1 and all(
                np.shape(d[0]) == np.shape(group[0][0])
                and np.shape(d[1]) == np.shape(group[0][1]) for d in group[1:])
            if uniform:
                xs, ys = self._device_chunk(group, dtype=feed_dtype)
                batches = [([p[k] for p in xs], [p[k] for p in ys]) for k in range(len(group))]
            else:
                batches = [self._device_batch(d[0], d[1], dtype=feed_dtype) for d in group]
            for k, (x, y) in enumerate(batches):
                replicas, opt_state, acc, stats = _train_step(
                    replicas, opt_state, acc, tuple(x), tuple(y), neg_ws[s0 + k], lrs[s0 + k], meta, layout,
                    true_acc=true_accumulation)
                params = replicas[0]
                # stats stay on the device until a validation point
                pending_stats.append(stats)
            step_ndx = s0 + len(group) - 1

            run_val = step_ndx in val_steps and step_ndx > 1
            if run_val or len(pending_stats) >= 256:
                flush_stats()
            if run_val and false_positive_val_data is not None:
                val_fp = 0
                for data_val in false_positive_val_data:
                    preds = self.forward(data_val[0], params=live())
                    val_fp += self.fp(preds, np.asarray(data_val[1]))
                self.history["val_fp_per_hr"].append(val_fp / val_set_hrs)
                self.best_val_fp = min(self.best_val_fp, val_fp / val_set_hrs)

            if run_val and positive_test_clips is not None:
                tp = fn = 0
                for data_val in positive_test_clips:
                    x_val = np.asarray(data_val[0], np.float32)
                    F = self.input_shape[0]
                    if x_val.shape[1] < F:
                        continue          # too short to hold one window
                    windows = np.concatenate([x_val[:, i:i + F]
                                              for i in range(0, x_val.shape[1] - F + 1)])
                    preds = self.forward(windows, params=live())
                    if np.any(preds >= 0.5):
                        tp += 1
                    else:
                        fn += 1
                self.history["positive_test_clips_recall"].append(tp / max(tp + fn, 1))

            if run_val and X_val is not None:
                # aggregated over every val batch, weighted by batch size
                accs, recalls, n_exam = [], [], []
                val_fp = 0
                for data_val in X_val:
                    x_val, y_val = np.asarray(data_val[0], np.float32), np.asarray(data_val[1])
                    preds = self.forward(x_val, params=live())
                    recalls.append(self.recall(preds, y_val))
                    accs.append(self.accuracy(preds, y_val))
                    val_fp += self.fp(preds, y_val)
                    n_exam.append(len(y_val))
                if n_exam:
                    w = np.asarray(n_exam, np.float64) / sum(n_exam)
                    self.history["val_accuracy"].append(float(np.dot(w, accs)))
                    self.history["val_recall"].append(float(np.dot(w, recalls)))
                    self.history["val_n_fp"].append(val_fp)

            if run_val and self.history["val_n_fp"]:
                if self.history["val_n_fp"][-1] <= np.percentile(self.history["val_n_fp"], 50) and \
                   self.history["val_recall"][-1] >= np.percentile(self.history["val_recall"], 5):
                    self.best_models.append({"__meta__": dict(self.meta), **_numpy(layout.views(params))})
                    self.best_model_scores.append({
                        "training_step_ndx": step_ndx,
                        "val_n_fp": self.history["val_n_fp"][-1],
                        "val_recall": self.history["val_recall"][-1],
                        "val_accuracy": self.history["val_accuracy"][-1],
                        "val_fp_per_hr": (self.history["val_fp_per_hr"] or [0])[-1],
                    })
                    self.best_val_recall = self.history["val_recall"][-1]
                    self.best_val_accuracy = self.history["val_accuracy"][-1]

            if step_ndx == max_steps - 1:
                break

        flush_stats()
        self.params = {"__meta__": dict(self.meta), **_numpy(layout.views(params))}
        self.opt_state = {"count": opt_state["count"], "mu": _unflatten(layout.views(opt_state["mu"])),
                          "nu": _unflatten(layout.views(opt_state["nu"]))}
        return self.params

    # -- orchestration ---------------------------------------------------

    def average_models(self, models: Optional[List[Dict]] = None) -> Dict:
        """Uniform weight average of checkpoint trees (train.py:198-223)."""
        models = models if models is not None else self.best_models
        flats = [{k: np.asarray(v) for k, v in _flatten(m).items()} for m in models]
        avg = {k: np.mean(np.stack([f[k] for f in flats]), axis=0) for k in flats[0]}
        return {"__meta__": dict(self.meta), **_unflatten(avg)}

    def _select_best_model(self, false_positive_validate_data, val_set_hrs=11.3,
                           max_fp_per_hour=0.5, min_recall=0.20):
        """Best snapshot: lowest-FP candidates, then max recall (train.py:225-259)."""
        if not self.best_models:
            return None
        fp_rates = [0.0] * len(self.best_models)
        for batch in false_positive_validate_data:
            x_val, y_val = np.asarray(batch[0], np.float32), np.asarray(batch[1])
            for ndx, model in enumerate(self.best_models):
                preds = self.forward(x_val, params=model)
                fp_rates[ndx] += self.fp(preds, y_val)
        fp_rates = [fp / val_set_hrs for fp in fp_rates]
        candidates = [ndx for ndx, fp in enumerate(fp_rates) if fp <= max_fp_per_hour]
        if not candidates:
            logging.warning("No models with FP/hr <= %s found!", max_fp_per_hour)
            return None
        recalls = [self.best_model_scores[ndx]["val_recall"] for ndx in candidates]
        if max(recalls) <= min_recall:
            logging.warning("No models with recall >= %s found!", min_recall)
            return None
        return self.best_models[candidates[int(np.argmax(recalls))]]

    def auto_train(self, X_train, X_val, false_positive_val_data, steps=50000,
                   max_negative_weight=1000, target_fp_per_hour=0.2, lr=1e-4,
                   val_set_hrs=11.3):
        """3-sequence schedule with negative-weight doubling and percentile
        checkpoint merging (train.py:261-366)."""
        seq_steps = int(steps)
        for sequence in range(3):
            if sequence > 0:
                lr = lr / 10
                if sequence == 1:
                    seq_steps = max(int(steps) // 10, 1)
                if self.best_val_fp > target_fp_per_hour:
                    max_negative_weight *= 2
                    logging.info("Increasing weight on negative examples to reduce false positives...")
            self.history["max_negative_weight"].append(max_negative_weight)
            weights = np.linspace(1, max_negative_weight, seq_steps).tolist()
            if sequence == 0:
                val_steps = np.linspace(seq_steps - int(seq_steps * 0.25), seq_steps, 20).astype(np.int64)
            else:
                val_steps = np.linspace(1, seq_steps, 20).astype(np.int64)
            logging.info("Starting training sequence %d...", sequence + 1)
            self.train_model(X=X_train, X_val=X_val,
                             false_positive_val_data=false_positive_val_data,
                             max_steps=seq_steps, negative_weight_schedule=weights,
                             val_steps=val_steps, warmup_steps=seq_steps // 5,
                             hold_steps=seq_steps // 3, lr=lr, val_set_hrs=val_set_hrs)

        logging.info("Merging checkpoints above the 90th percentile into single model...")
        combined = self.params
        if self.best_models and self.history["val_accuracy"]:
            accuracy_pct = np.percentile(self.history["val_accuracy"], 90)
            recall_pct = np.percentile(self.history["val_recall"], 90)
            fp_pct = np.percentile(self.history["val_fp_per_hr"], 10) \
                if self.history["val_fp_per_hr"] else 0
            models = [m for m, s in zip(self.best_models, self.best_model_scores)
                      if s["val_accuracy"] >= accuracy_pct and s["val_recall"] >= recall_pct
                      and s["val_fp_per_hr"] <= fp_pct]
            if models:
                combined = self.average_models(models=models)

        # the combined model's validation report (train.py:345-364), over
        # every val batch
        if X_val is not None:
            preds_all, y_all = [], []
            for batch in X_val:
                preds_all.append(self.forward(np.asarray(batch[0], np.float32), params=combined))
                y_all.append(np.asarray(batch[1]))
            if y_all:
                preds = np.concatenate(preds_all)
                y = np.concatenate(y_all)
                logging.info("Final Model Accuracy: %s | Recall: %s",
                             self.accuracy(preds, y), self.recall(preds, y))
        return combined

    # -- prediction / persistence ----------------------------------------

    def predict_on_features(self, features: np.ndarray, model=None) -> np.ndarray:
        """Sliding 16-frame windows, step 1 (80 ms), per clip (train.py:368-396),
        the final valid window included."""
        features = np.asarray(features, np.float32)
        if features.ndim < 3:
            features = features[None]
        n_in = self.input_shape[0]
        out = []
        for clip in features:
            if clip.shape[0] < n_in:
                raise ValueError(
                    f"Clip has {clip.shape[0]} feature frames; the head needs "
                    f"at least {n_in} for one window")
            windows = np.stack([clip[i:i + n_in]
                                for i in range(0, clip.shape[0] - n_in + 1)])
            out.append(self.forward(windows, params=model)[None])
        return np.vstack(out)

    def predict_on_clips(self, clips: np.ndarray, model=None) -> np.ndarray:
        from openwakeword_tpu_torch.features import AudioFeatures
        F = AudioFeatures(device=self.device)
        features = F.embed_clips(np.asarray(clips), batch_size=16)
        return self.predict_on_features(features, model=model)

    def _checkpoint_tree(self, model) -> Dict:
        model = model or self.params
        return {"__meta__": dict(model.get("__meta__", self.meta)), **_numpy(_tensors(model, "cpu"))}

    def save_model(self, output_path: str, model=None, meta: dict = None):
        """Write the head as a native ``.npz`` checkpoint. ``meta`` rides the
        file-level metadata, e.g. ``{"embedding": "student"}`` for the
        feature frontend the head was trained on."""
        from openwakeword_tpu_torch.io.checkpoints import save_checkpoint
        save_checkpoint(output_path, "head", self._checkpoint_tree(model), meta=meta)

    # -- mid-run checkpoint / resume ----------------------------------------

    def save_state(self, path: str):
        """Persist the whole trainer state: params, optimizer state, history,
        snapshots and their scores (numpy, pickled)."""
        opt = _adam_state_to(self.opt_state, "cpu")
        state = {
            "params": _numpy(_tensors(self.params, "cpu")),
            "meta": dict(self.meta),
            "opt_state": {"count": opt["count"].numpy(), "mu": _numpy(opt["mu"]), "nu": _numpy(opt["nu"])},
            "history": {k: list(v) for k, v in self.history.items()},
            "best_models": [_numpy(_tensors(m, "cpu")) for m in self.best_models],
            "best_model_scores": list(self.best_model_scores),
            "best_val_fp": self.best_val_fp,
            "best_val_accuracy": self.best_val_accuracy,
            "best_val_recall": self.best_val_recall,
        }
        with open(path, "wb") as f:
            pickle.dump(state, f)

    def load_state(self, path: str):
        """Resume from ``save_state`` output."""
        with open(path, "rb") as f:
            state = pickle.load(f)
        self.meta = dict(state["meta"])
        self.params = {"__meta__": dict(self.meta), **state["params"]}
        self.opt_state = _adam_state_to(state["opt_state"], self.device)
        self.history = defaultdict(list, {k: list(v) for k, v in state["history"].items()})
        self.best_models = [{"__meta__": dict(self.meta), **m} for m in state["best_models"]]
        self.best_model_scores = list(state["best_model_scores"])
        self.best_val_fp = state["best_val_fp"]
        self.best_val_accuracy = state["best_val_accuracy"]
        self.best_val_recall = state["best_val_recall"]

    def export_model(self, model, model_name: str, output_dir: str):
        """Write the head as a native ``.npz`` checkpoint and an ``.onnx``
        file (``io.onnx_export``); a head family the exporter lacks gets the
        ``.npz`` only, with a warning."""
        self.save_model(os.path.join(output_dir, model_name + ".npz"), model=model)
        try:
            from openwakeword_tpu_torch.io.onnx_export import export_head_onnx
            export_head_onnx(self._checkpoint_tree(model), os.path.join(output_dir, model_name + ".onnx"))
        except NotImplementedError:
            logging.warning("ONNX export unavailable; native checkpoint saved only.")

    def export_to_onnx(self, output_path: str, class_mapping: str = ""):
        """Write this head as a standalone ``.onnx`` file; ``class_mapping``
        names the graph's output tensor, as in the reference."""
        from openwakeword_tpu_torch.io.onnx_export import export_head_onnx
        export_head_onnx(self._checkpoint_tree(None), output_path, output_name=class_mapping)

    def lr_warmup_cosine_decay(self, global_step, warmup_steps=0, hold=0,
                               total_steps=0, start_lr=0.0, target_lr=1e-3):
        """Method alias of the module-level schedule (train.py:25-40)."""
        return lr_warmup_cosine_decay(global_step, warmup_steps=warmup_steps,
                                      hold=hold, total_steps=total_steps,
                                      start_lr=start_lr, target_lr=target_lr)

    def summary(self):
        """Print a per-layer parameter-count summary."""
        total = 0
        for name, leaves in sorted(self._leaf(self.params).items()):
            flat = _flatten(leaves) if isinstance(leaves, dict) else {name: leaves}
            n = sum(int(np.asarray(v).size) for v in flat.values())
            total += n
            print(f"{name:<24s} {n:>10,d} params")
        print(f"{'total':<24s} {total:>10,d} params")
        return total
