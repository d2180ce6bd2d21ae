"""Import reference .onnx artifacts into param dicts (counterpart of
``openwakeword_tpu.io.onnx_import``; the output equals the JAX importer's
key for key, numpy in the checkpoint layout).

Handles the artifact families the reference distributes: classifier heads
(torch.onnx exports: Gemm/MatMul+Add chains with decomposed LayerNorm,
Sigmoid/Softmax tails, and the rnn family's LSTMs), the speech-embedding CNN
(Conv/BatchNormalization/MaxPool graph) and the Silero VAD graph (run as a
program, ``models.silero``). Import is order-based against the known fixed
architectures: the graphs are frozen exports, so parameter order is
deterministic. A classifier graph outside the families runs as a generic
'graph' head through ``io.onnx_graph``.
"""

from typing import Dict, List, Tuple

import numpy as np

from openwakeword_tpu_torch.io import onnx_proto as op
from openwakeword_tpu_torch.models import embedding as embedding_model


def _onnx_gates_to_torch(m: np.ndarray) -> np.ndarray:
    """ONNX LSTM gate blocks [i, o, f, c] -> torch's [i, f, c, o]."""
    h = m.shape[0] // 4
    i, o, f, c = m[:h], m[h:2 * h], m[2 * h:3 * h], m[3 * h:4 * h]
    return np.concatenate([i, f, c, o], axis=0)


def _all_op_types(graph: Dict):
    """Op types of a graph including If/Loop subgraphs (Silero nests its
    per-sample-rate models inside If branches)."""
    for n in graph["nodes"]:
        yield n["op_type"]
        for a in n["attributes"].values():
            if "g" in a:
                yield from _all_op_types(a["g"])
            for sub in a.get("graphs", []):
                yield from _all_op_types(sub)


def _classify(graph: Dict) -> str:
    ins = [i for i in graph["inputs"] if i["name"] not in graph["initializers"]]
    # Heads take (B, frames, 96) embedding windows -- classify by that input
    # shape BEFORE the LSTM rule, so rnn-family heads (reference
    # train.py:84-96 exports contain LSTM nodes) aren't mistaken for VAD.
    if ins:
        shape = ins[0]["shape"]
        concrete = [d for d in shape if isinstance(d, int)]
        if len(shape) == 3 and concrete and concrete[-1] == 96:
            return "head"
    # VAD: recurrent state carried through the graph I/O (h/c of the Silero
    # contract, reference vad.py:92-96), or any LSTM in the (sub)graphs.
    n_state = sum(1 for i in ins
                  if len(i["shape"]) == 3 and i["shape"][0] == 2 and i["shape"][-1] == 64)
    if n_state >= 2 or "LSTM" in set(_all_op_types(graph)):
        return "vad"
    if ins:
        shape = ins[0]["shape"]
        concrete = [d for d in shape if isinstance(d, int)]
        if len(shape) == 4 and concrete[-2:] in ([32, 1],) or \
           (len(shape) == 4 and 76 in concrete and 32 in concrete):
            return "embedding"
        if len(shape) == 2:
            # melspectrogram frontend: a Conv STFT with no dense layers and
            # no activations (torchlibrosa exports carry a MatMul for the
            # mel projection, so Gemm-absence -- not MatMul-absence -- is
            # the discriminator; heads always contain activations).
            ops = {n["op_type"] for n in graph["nodes"]}
            if "Conv" in ops and not ops & {"Gemm", "Relu", "Sigmoid",
                                            "Softmax", "Tanh"}:
                return "melspectrogram"
            return "head"
    ops = [n["op_type"] for n in graph["nodes"]]
    if ops.count("Conv") > 10:
        return "embedding"
    if "LSTM" in ops:
        return "vad"
    return "head"


# ---------------------------------------------------------------------------
# Heads
# ---------------------------------------------------------------------------

def _extract_linears_and_lns(graph: Dict) -> Tuple[List[Dict], List[Dict], Dict]:
    """Walk nodes in graph order collecting Linear layers and LayerNorms.

    Linear: Gemm (with optional transB) or MatMul followed by Add-with-vector.
    LayerNorm: a Div whose denominator chain contains Sqrt, followed by
    Mul(gamma initializer) and Add(beta initializer) -- covers both this
    package's exporter and torch's opset-13 decomposition.
    """
    inits = graph["initializers"]
    producers = {}
    for n in graph["nodes"]:
        for o in n["output"]:
            producers[o] = n

    linears: List[Dict] = []
    lns: List[Dict] = []
    # Adds consumed as a MatMul bias or LN beta: skipped when scanning (an
    # initializer-Add is otherwise indistinguishable from a residual add)
    consumed_adds = set()
    tail = {"activation": None, "relu_before_softmax": False}

    def _from_sqrt(name, depth=0):
        n = producers.get(name)
        if n is None or depth > 4:
            return False
        if n["op_type"] == "Sqrt":
            return True
        return any(_from_sqrt(i, depth + 1) for i in n["input"])

    nodes = graph["nodes"]
    for idx, n in enumerate(nodes):
        if id(n) in consumed_adds:
            continue
        t = n["op_type"]
        if t == "LayerNormalization":
            # single-op form (torch opset >= 17 exports): scale/bias are
            # inputs 1 and 2
            if len(n["input"]) < 3 or n["input"][1] not in inits \
                    or n["input"][2] not in inits:
                raise ValueError("LayerNormalization without initializer "
                                 "scale/bias is not a supported head form")
            # the runtime LN (models/heads.py:_layer_norm) hardcodes
            # eps=1e-5 / axis=-1; a head exported with different values
            # would score with silent systematic drift — reject instead
            attrs = n.get("attributes", {})
            eps = attrs.get("epsilon", {}).get("f", 1e-5)
            axis = attrs.get("axis", {}).get("i", -1)
            if abs(eps - 1e-5) > 1e-12:
                raise ValueError(
                    f"LayerNormalization epsilon={eps!r} differs from the "
                    "runtime's 1e-5; re-export the head with the default "
                    "epsilon or extend heads._layer_norm to thread it")
            if axis not in (-1, 1):
                # head activations are (B, D): axis -1 and 1 are the same
                # (torch exports either form); anything else is not last-axis
                raise ValueError(
                    f"LayerNormalization axis={axis} is unsupported; the "
                    "runtime normalizes the last axis only")
            lns.append({"gamma": np.asarray(inits[n["input"][1]], np.float32),
                        "beta": np.asarray(inits[n["input"][2]], np.float32)})
            continue
        if t == "Gemm":
            w = np.asarray(inits[n["input"][1]], np.float32)
            b = np.asarray(inits[n["input"][2]], np.float32) if len(n["input"]) > 2 \
                else np.zeros(w.shape[-1], np.float32)
            trans_b = n["attributes"].get("transB", {}).get("i", 0)
            if trans_b:
                w = w.T
            linears.append({"w": w, "b": b})
        elif t == "MatMul" and n["input"][1] in inits:
            w = np.asarray(inits[n["input"][1]], np.float32)
            b = np.zeros(w.shape[-1], np.float32)
            # look ahead for the bias Add
            for m in nodes[idx + 1:idx + 3]:
                if m["op_type"] == "Add" and n["output"][0] in m["input"]:
                    other = [i for i in m["input"] if i != n["output"][0]][0]
                    if other in inits and inits[other].ndim == 1:
                        b = np.asarray(inits[other], np.float32)
                        consumed_adds.add(id(m))
                    break
            linears.append({"w": w, "b": b})
        elif t == "Div" and _from_sqrt(n["input"][1]):
            gamma = beta = None
            cur = n["output"][0]
            for m in nodes[idx + 1:idx + 6]:
                if cur in m["input"]:
                    other = [i for i in m["input"] if i != cur]
                    if m["op_type"] == "Mul" and other and other[0] in inits and gamma is None:
                        gamma = np.asarray(inits[other[0]], np.float32)
                        cur = m["output"][0]
                    elif m["op_type"] == "Add" and other and other[0] in inits and gamma is not None:
                        beta = np.asarray(inits[other[0]], np.float32)
                        consumed_adds.add(id(m))
                        break
            if gamma is not None and beta is not None:
                lns.append({"gamma": gamma, "beta": beta})
        elif t == "Sigmoid":
            tail["activation"] = "sigmoid"
        elif t == "Softmax":
            tail["activation"] = "softmax"
            prev = producers.get(n["input"][0])
            if prev is not None and prev["op_type"] == "Relu":
                tail["relu_before_softmax"] = True
    return linears, lns, tail


def _extract_rnn_head(graph: Dict) -> Dict:
    """rnn-family head (reference train.py:84-96: stacked bidirectional LSTM
    -> Linear -> Sigmoid) -> native lstm{layer}_{fwd,bwd} params. ONNX packs
    per-direction weights as W (2, 4H, I) / R (2, 4H, H) / B (2, 8H) in gate
    order [i, o, f, c]; the native format is torch's (I, 4H) / (H, 4H)
    column-major [i, f, g, o]."""
    inits = graph["initializers"]
    params: Dict = {}
    hidden = None
    lstms = [n for n in graph["nodes"] if n["op_type"] == "LSTM"]
    if len(lstms) != 2:
        # heads.forward's rnn family is exactly 2 stacked layers; accepting
        # other depths would crash (1 layer) or silently mis-score (3+)
        raise ValueError(f"rnn head has {len(lstms)} LSTM layers; the rnn "
                         "family is 2 stacked bidirectional layers "
                         "(reference train.py:84-96)")
    for layer, n in enumerate(lstms):
        direction = n["attributes"].get("direction", {}).get("s", b"forward").decode()
        if direction != "bidirectional":
            raise ValueError(f"rnn head LSTM layer {layer} has direction "
                             f"'{direction}'; the rnn family is bidirectional")
        W = np.asarray(inits[n["input"][1]], np.float32)
        R = np.asarray(inits[n["input"][2]], np.float32)
        hidden = int(R.shape[-1])          # authoritative (attr is optional)
        attr_hidden = int(n["attributes"].get("hidden_size", {}).get("i", hidden))
        if attr_hidden != hidden:
            raise ValueError(f"rnn head LSTM layer {layer}: hidden_size attr "
                             f"{attr_hidden} != recurrence width {hidden}")
        has_b = len(n["input"]) > 3 and n["input"][3] in inits
        B = (np.asarray(inits[n["input"][3]], np.float32) if has_b
             else np.zeros((W.shape[0], 8 * hidden), np.float32))
        for d, tag in enumerate(("fwd", "bwd")):
            params[f"lstm{layer}_{tag}"] = {
                "w_ih": _onnx_gates_to_torch(W[d]).T.copy(),
                "w_hh": _onnx_gates_to_torch(R[d]).T.copy(),
                "b_ih": _onnx_gates_to_torch(B[d, :4 * hidden]),
                "b_hh": _onnx_gates_to_torch(B[d, 4 * hidden:]),
            }
    return params


def import_head_onnx(path: str, graph: Dict = None) -> Tuple[Dict, Dict]:
    """ONNX head -> (params pytree with __meta__, meta dict)."""
    if graph is None:
        graph = op.load_onnx(path)["graph"]
    if any(n["op_type"] == "LSTM" for n in graph["nodes"]):
        # same vocabulary discipline as the dnn/mlp gate below: the rnn
        # extractor only validates LSTM count/direction and FC count, so a
        # foreign graph (conv stem + stacked LSTMs + FC) would pass and be
        # silently rebuilt with the stem dropped. Restrict to the ops an
        # rnn-family export can contain (ours: io/onnx_export.py
        # export_head_onnx; torch exports add shape plumbing) and let the
        # caller's fallback route anything else to the general compiler.
        _rnn_family_ops = {
            "LSTM", "Transpose", "Reshape", "Slice", "Squeeze", "Unsqueeze",
            "Concat", "Gemm", "MatMul", "Add", "Sigmoid", "Softmax", "Relu",
            "Identity", "Constant", "Shape", "Gather", "Cast",
        }
        extra = {n["op_type"] for n in graph["nodes"]} - _rnn_family_ops
        if extra:
            raise ValueError(
                f"{path}: ops {sorted(extra)} are outside the rnn head "
                "vocabulary — not a train.py rnn-family export")
        params = _extract_rnn_head(graph)
        linears, _lns, tail = _extract_linears_and_lns(graph)
        if len(linears) != 1:
            raise ValueError(f"rnn head has {len(linears)} linear layers; "
                             "expected one output projection")
        params["out"] = linears[0]
        hidden = params["lstm0_fwd"]["w_hh"].shape[0]
        ins = [i for i in graph["inputs"] if i["name"] not in graph["initializers"]]
        frames = ins[0]["shape"][1] if ins and len(ins[0]["shape"]) == 3 else None
        if not isinstance(frames, int):
            # a symbolic/dynamic frames dim cannot be recovered from the
            # weights (unlike dnn/mlp); guessing would feed the head wrongly
            # sized windows and score silently wrong
            raise ValueError(f"rnn head input frames dim is {frames!r}; "
                             "re-export with a concrete window length")
        n_classes = int(linears[0]["w"].shape[-1])
        params["__meta__"] = {
            "model_type": "rnn",
            "input_frames": int(frames),
            "n_classes": n_classes,
            "layer_dim": int(hidden),
            "n_blocks": len([k for k in params if k.endswith("_fwd")]),
        }
        if n_classes > 1:
            params["__meta__"]["relu_logits"] = bool(tail["relu_before_softmax"])
        out_names = [o["name"] for o in graph["outputs"]]
        return params, {"kind": "head", "output_names": out_names}
    # The order-based extraction is only sound for graphs that ARE a
    # train.py family: (a) no ops outside the family vocabulary (an
    # attention-pooled head, say, contains the same 3 linears an mlp does —
    # rebuilding it as an mlp would score silently wrong), and (b) the
    # linear dims must chain input->hidden->...->classes. The vocabulary
    # gate runs BEFORE extraction: foreign graphs (e.g. QDQ-quantized, conv
    # towers) can have Gemm weights that are computed tensors rather than
    # initializers, which the extractor cannot even walk.
    _family_ops = {
        "Gemm", "MatMul", "Add", "Relu", "Sigmoid", "Softmax", "Reshape",
        "Flatten", "Identity", "Constant", "Shape", "Gather", "Unsqueeze",
        "Concat", "Cast", "Dropout",
        # decomposed / single-op LayerNorm
        "ReduceMean", "Sub", "Pow", "Sqrt", "Div", "Mul", "LayerNormalization",
    }
    extra = {n["op_type"] for n in graph["nodes"]} - _family_ops
    if extra:
        raise ValueError(
            f"{path}: ops {sorted(extra)} are outside the dnn/mlp head "
            "vocabulary — not a train.py family export")
    linears, lns, tail = _extract_linears_and_lns(graph)
    if not linears:
        raise ValueError(f"No linear layers found in ONNX head graph at {path}")
    for a, b in zip(linears, linears[1:]):
        if a["w"].shape[-1] != b["w"].shape[0]:
            raise ValueError(
                f"{path}: linear layers do not chain "
                f"({a['w'].shape} -> {b['w'].shape}); not a sequential "
                "dnn/mlp head")

    n_in = linears[0]["w"].shape[0]
    if n_in % 96 != 0:
        raise ValueError(f"Head input dim {n_in} is not a multiple of the 96-d embedding")
    input_frames = n_in // 96
    n_classes = linears[-1]["w"].shape[-1]
    layer_dim = linears[0]["w"].shape[-1]

    params: Dict = {}
    if lns:
        if len(lns) != len(linears) - 1:
            raise ValueError(f"Unexpected head structure: {len(linears)} linears, {len(lns)} layernorms")
        n_blocks = len(lns) - 1
        meta = {"model_type": "dnn", "input_frames": input_frames, "n_classes": n_classes,
                "layer_dim": layer_dim, "n_blocks": n_blocks}
        params["layer1"] = linears[0]
        params["ln1"] = lns[0]
        for i in range(n_blocks):
            params[f"block{i}_fc"] = linears[1 + i]
            params[f"block{i}_ln"] = lns[1 + i]
        params["out"] = linears[-1]
    else:
        if len(linears) != 3:
            raise ValueError(f"Unexpected LN-free head with {len(linears)} linears (expected 3 for 'mlp')")
        meta = {"model_type": "mlp", "input_frames": input_frames, "n_classes": n_classes,
                "layer_dim": layer_dim}
        params["layer1"], params["layer2"], params["out"] = linears
    if n_classes > 1:
        meta["relu_logits"] = bool(tail["relu_before_softmax"])
    params["__meta__"] = meta

    out_names = [o["name"] for o in graph["outputs"]]
    file_meta = {"kind": "head", "output_names": out_names}
    return params, file_meta


# ---------------------------------------------------------------------------
# Embedding CNN
# ---------------------------------------------------------------------------

def import_embedding_onnx(path: str, graph: Dict = None) -> Dict:
    """ONNX speech-embedding CNN -> native embedding params.

    Order-based: the graph's Conv weights (OIHW -> HWIO) and
    BatchNormalization (scale, B, mean, var) params are assigned to our fixed
    layer program in topological order, then shape-checked against the spec
    (conversion notebook cell 18)."""
    if graph is None:
        graph = op.load_onnx(path)["graph"]
    inits = graph["initializers"]
    convs, bns = [], []
    for n in graph["nodes"]:
        if n["op_type"] == "Conv" and n["input"][1] in inits:
            w = np.asarray(inits[n["input"][1]], np.float32)      # OIHW
            convs.append(np.transpose(w, (2, 3, 1, 0)))            # -> HWIO
        elif n["op_type"] == "BatchNormalization":
            eps = n["attributes"].get("epsilon", {}).get("f", 1e-5)
            if abs(eps - embedding_model.BN_EPS) > 1e-9:
                raise ValueError(
                    f"Embedding graph BatchNormalization epsilon {eps} != the "
                    f"Keras-export value {embedding_model.BN_EPS} assumed by "
                    "fold_batchnorm (models/embedding.py)")
            gamma, beta, mean, var = (np.asarray(inits[i], np.float32) for i in n["input"][1:5])
            bns.append({"gamma": gamma, "beta": beta, "mean": mean, "var": var})

    expected = embedding_model.init_params(np.random.default_rng(0))
    n_convs = sum(1 for k in expected if k.startswith("conv_"))
    n_bns = sum(1 for k in expected if k.startswith("bn_"))
    if len(convs) != n_convs or len(bns) != n_bns:
        raise ValueError(f"Embedding graph has {len(convs)} convs / {len(bns)} BNs; "
                         f"expected {n_convs} / {n_bns}")
    params: Dict = {}
    for i, w in enumerate(convs):
        want = expected[f"conv_{i}"]["w"].shape
        if tuple(w.shape) != tuple(want):
            raise ValueError(f"conv_{i} shape {w.shape} != expected {want}")
        params[f"conv_{i}"] = {"w": w}
    for i, bn in enumerate(bns):
        params[f"bn_{i}"] = bn
    return params


# ---------------------------------------------------------------------------
# VAD (Silero graph: STFT-conv frontend + LSTM decoder + If sample-rate switch)
# ---------------------------------------------------------------------------

def import_vad_onnx(path: str, graph: Dict = None) -> Tuple[Dict, Dict]:
    """Silero-family VAD .onnx -> (params, meta with the program spec). The
    graph runs through ``io.onnx_graph`` with sr pinned to 16 kHz."""
    from openwakeword_tpu_torch.models import silero
    if graph is None:
        graph = op.load_onnx(path)["graph"]
    prog = silero.import_onnx(graph)
    meta = {"kind": "vad", "format": "onnx_program", "spec": prog.program.to_spec()}
    return prog.params, meta


# ---------------------------------------------------------------------------

def import_graph_head_onnx(path: str, graph: Dict = None) -> Tuple[Dict, Dict]:
    """Arbitrary-architecture ONNX classifier -> generic 'graph' head.

    The reference serves any user-supplied .onnx through onnxruntime, not
    only the dnn/mlp/rnn families its own train.py produces. Architectures
    the order-based family extractors do not recognize run through the
    graph executor (``io.onnx_graph.OnnxProgram``) instead of being
    rejected.

    The head contract is inferred from the graph I/O: one dynamic input
    shaped (B, F, 96) or (B, F*96) embedding windows; the first output is
    the score vector (the graph carries its own sigmoid/softmax tail, as
    every exported head does). n_classes is measured by running the graph
    once on zeros.
    """
    from openwakeword_tpu_torch.io.graph_head import build_graph_head
    from openwakeword_tpu_torch.io.onnx_graph import OnnxProgram

    if graph is None:
        graph = op.load_onnx(path)["graph"]
    prog = OnnxProgram(graph)
    if len(prog.input_names) != 1:
        raise ValueError(
            f"{path}: generic head import needs exactly one dynamic input, "
            f"got {prog.input_names} — stateful/multi-input graphs have no "
            "standard wakeword-head calling convention")
    info = next(i for i in graph["inputs"] if i["name"] == prog.input_names[0])
    return build_graph_head(prog, info["shape"], path)


def import_onnx_model(path: str) -> Tuple[str, Dict, Dict]:
    """Entry point of ``io.loaders``: (kind, numpy params, meta)."""
    model = op.load_onnx(path)
    graph = model["graph"]
    kind = _classify(graph)
    if kind == "head":
        try:
            params, meta = import_head_onnx(path, graph)
        except ValueError:
            # not one of the train.py families — compile the graph as-is
            params, meta = import_graph_head_onnx(path, graph)
        return "head", params, meta
    if kind == "embedding":
        return "embedding", import_embedding_onnx(path, graph), {"kind": "embedding"}
    if kind == "vad":
        params, meta = import_vad_onnx(path, graph)
        return "vad", params, meta
    if kind == "melspectrogram":
        raise ValueError("The melspectrogram frontend is analytic in this framework; "
                         "no import needed (openwakeword_tpu_torch.ops.melspec).")
    # unrecognized family: fall back to the general compiler before giving up
    params, meta = import_graph_head_onnx(path, graph)
    return "head", params, meta
