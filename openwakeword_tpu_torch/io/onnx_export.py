"""Export the pipeline's models as ONNX graphs (counterpart of
``openwakeword_tpu.io.onnx_export``).

Covers every artifact family the reference distributes:

  * heads (``export_head_onnx``): Gemm chains with decomposed LayerNorm for
    ``dnn`` / ``mlp``, a bidirectional ONNX ``LSTM`` per layer for ``rnn``;
  * the mel frontend (``export_melspectrogram_onnx``): the windowed DFT as
    a strided Conv, power, the mel MatMul and librosa's power_to_db, input
    raw int16-range PCM (batch, samples), output (batch, frames, 32);
  * the VAD network (``export_vad_onnx``) with the Silero I/O contract;
  * the speech-embedding CNN (``export_embedding_onnx``) in the unfolded
    Conv / BatchNormalization form.

Params are the port's: dicts of tensors on any device, or numpy, heads with
their ``"__meta__"``, embedding convs OIHW. Every array is written as
float32 from the params as given (never from a tier's rounded
``product_params``). The graphs use only primitive ops at opset 13 and are
written op for op, name for name as the JAX package writes them, so both
packages' files of equal params are the same bytes.
"""

from typing import Dict

import numpy as np
import torch

from openwakeword_tpu_torch import config
from openwakeword_tpu_torch.io import onnx_proto as op


def as_numpy(x) -> np.ndarray:
    """A tensor on any device, or anything numpy reads, as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def _torch_gates_to_onnx(m: np.ndarray) -> np.ndarray:
    """Reorder LSTM gate blocks from torch's [i, f, g, o] to ONNX's
    [i, o, f, c] (c == torch's g) on the leading axis of a (4H, ...) weight
    or (4H,) bias."""
    h = m.shape[0] // 4
    i, f, g, o = m[:h], m[h:2 * h], m[2 * h:3 * h], m[3 * h:4 * h]
    return np.concatenate([i, o, f, g], axis=0)


def _lstm_wrb(p: Dict):
    """LSTM params {w_ih (I, 4H), w_hh (H, 4H), b_ih, b_hh} -> one
    direction's ONNX (W (4H, I), R (4H, H), B (8H,)), gates reordered."""
    return (_torch_gates_to_onnx(as_numpy(p["w_ih"]).T),
            _torch_gates_to_onnx(as_numpy(p["w_hh"]).T),
            np.concatenate([_torch_gates_to_onnx(as_numpy(p["b_ih"])),
                            _torch_gates_to_onnx(as_numpy(p["b_hh"]))]))


def _write(path: str, model: bytes) -> None:
    with open(path, "wb") as f:
        f.write(model)


def export_head_onnx(params: Dict, path: str, output_name: str = ""):
    """Write a ``dnn``, ``mlp`` or ``rnn`` head as an .onnx graph: input
    ``(batch, frames, 96)``, output ``(batch, n_classes)`` (sigmoid, or
    softmax over the classes). The output is named ``output_name``, else the
    head's name, else "output"."""
    meta = params["__meta__"]
    model_type = meta["model_type"]
    if model_type not in ("dnn", "mlp", "rnn"):
        raise NotImplementedError(f"ONNX export for '{model_type}' heads is not supported yet")
    input_frames = int(meta["input_frames"])
    n_classes = int(meta["n_classes"])

    nodes, inits = [], []
    counter = [0]

    def t(name):
        counter[0] += 1
        return f"t{counter[0]}_{name}"

    def linear(x_name, p, out_name):
        wn, bn = out_name + "_w", out_name + "_b"
        inits.append(op.encode_tensor(wn, as_numpy(p["w"])))       # (in, out)
        inits.append(op.encode_tensor(bn, as_numpy(p["b"])))
        nodes.append(op.encode_node("Gemm", [x_name, wn, bn], [out_name]))
        return out_name

    def layer_norm(x_name, p, out_name, eps=1e-5):
        mean = t("mean")
        nodes.append(op.encode_node("ReduceMean", [x_name], [mean], axes=[-1], keepdims=1))
        centered = t("centered")
        nodes.append(op.encode_node("Sub", [x_name, mean], [centered]))
        sq = t("sq")
        nodes.append(op.encode_node("Mul", [centered, centered], [sq]))
        var = t("var")
        nodes.append(op.encode_node("ReduceMean", [sq], [var], axes=[-1], keepdims=1))
        eps_n = t("eps")
        inits.append(op.encode_tensor(eps_n, np.asarray(eps, np.float32).reshape(())))
        var_eps = t("var_eps")
        nodes.append(op.encode_node("Add", [var, eps_n], [var_eps]))
        std = t("std")
        nodes.append(op.encode_node("Sqrt", [var_eps], [std]))
        normed = t("normed")
        nodes.append(op.encode_node("Div", [centered, std], [normed]))
        gn, bn2 = t("ln_gamma"), t("ln_beta")
        inits.append(op.encode_tensor(gn, as_numpy(p["gamma"])))
        inits.append(op.encode_tensor(bn2, as_numpy(p["beta"])))
        scaled = t("scaled")
        nodes.append(op.encode_node("Mul", [normed, gn], [scaled]))
        nodes.append(op.encode_node("Add", [scaled, bn2], [out_name]))
        return out_name

    def relu(x_name, out_name):
        nodes.append(op.encode_node("Relu", [x_name], [out_name]))
        return out_name

    x = "input"
    if model_type in ("dnn", "mlp"):
        flat = t("flat")
        shape_n = t("flatten_shape")
        inits.append(op.encode_tensor(shape_n, np.asarray([0, input_frames * 96], np.int64)))
        nodes.append(op.encode_node("Reshape", [x, shape_n], [flat]))
        h = flat

    if model_type == "dnn":
        h = linear(h, params["layer1"], t("fc1"))
        h = layer_norm(h, params["ln1"], t("ln1"))
        h = relu(h, t("relu1"))
        i = 0
        while f"block{i}_fc" in params:
            h = linear(h, params[f"block{i}_fc"], t(f"block{i}_fc"))
            h = layer_norm(h, params[f"block{i}_ln"], t(f"block{i}_ln"))
            h = relu(h, t(f"block{i}_relu"))
            i += 1
    elif model_type == "mlp":
        h = linear(h, params["layer1"], t("fc1"))
        h = relu(h, t("relu1"))
        h = linear(h, params["layer2"], t("fc2"))
        h = relu(h, t("relu2"))
    else:  # rnn: stacked bidirectional LSTMs, last-timestep features
        hidden = params["lstm0_fwd"]["w_hh"].shape[0]
        xs = t("xs")
        nodes.append(op.encode_node("Transpose", [x], [xs], perm=[1, 0, 2]))
        n_layers = len({k for k in params if k.startswith("lstm")}) // 2
        for layer in range(n_layers):
            groups = [_lstm_wrb(params[f"lstm{layer}_{tag}"]) for tag in ("fwd", "bwd")]
            names = [f"lstm{layer}_{nm}" for nm in ("W", "R", "B")]
            for j, nm in enumerate(names):
                inits.append(op.encode_tensor(nm, np.stack([g[j] for g in groups])))
            y = t(f"lstm{layer}")
            nodes.append(op.encode_node("LSTM", [xs] + names, [y], hidden_size=int(hidden),
                                        direction="bidirectional"))
            if layer < n_layers - 1:
                # ONNX Y is (T, 2, B, H); the next layer wants (T, B, 2H)
                tr = t("dirs_last")
                nodes.append(op.encode_node("Transpose", [y], [tr], perm=[0, 2, 1, 3]))
                xs = t("merged")
                shp = t("merge_shape")
                inits.append(op.encode_tensor(shp, np.asarray([0, 0, -1], np.int64)))
                nodes.append(op.encode_node("Reshape", [tr, shp], [xs]))
            else:
                # the last timestep: fwd saw the whole window, bwd saw x[T-1]
                last = t("last")
                for nm, val in (("t_last_s", input_frames - 1), ("t_last_e", input_frames), ("t_axis0", 0)):
                    inits.append(op.encode_tensor(nm, np.asarray([val], np.int64)))
                nodes.append(op.encode_node("Slice", [y, "t_last_s", "t_last_e", "t_axis0"], [last]))
                tr = t("batch_first")
                nodes.append(op.encode_node("Transpose", [last], [tr], perm=[2, 0, 1, 3]))   # (B, 1, 2, H)
                h = t("features")
                shp = t("feat_shape")
                inits.append(op.encode_tensor(shp, np.asarray([0, -1], np.int64)))
                nodes.append(op.encode_node("Reshape", [tr, shp], [h]))

    logits = linear(h, params["out"], t("logits"))
    final = output_name or (meta.get("name") or "output")
    if n_classes == 1:
        nodes.append(op.encode_node("Sigmoid", [logits], [final]))
    else:
        if meta.get("relu_logits", True):
            logits = relu(logits, t("relu_logits"))
        nodes.append(op.encode_node("Softmax", [logits], [final], axis=1))

    _write(path, op.encode_model(
        nodes, inits,
        inputs=[op.encode_value_info("input", ["batch", input_frames, 96])],
        outputs=[op.encode_value_info(final, ["batch", n_classes])]))


def _stft_power_nodes(nodes, inits, basis: np.ndarray, hop: int, prefix: str, conv_name: str):
    """Reshape the (B, samples) input to NCW, convolve with the windowed DFT
    basis at stride ``hop`` and sum the squares of its interleaved (re, im)
    channels into "power" (B, n_freqs, T)."""
    n_freqs = basis.shape[1] // 2
    inits.append(op.encode_tensor("to_nchw", np.asarray([0, 1, -1], np.int64)))
    nodes.append(op.encode_node("Reshape", ["input", "to_nchw"], ["pcm"]))
    inits.append(op.encode_tensor(conv_name, np.ascontiguousarray(basis.T[:, None, :]).astype(np.float32)))
    nodes.append(op.encode_node("Conv", ["pcm", conv_name], ["spec"], strides=[hop]))
    for name, start in (("re", 0), ("im", 1)):
        inits += [op.encode_tensor(f"{prefix}{name}_s", np.asarray([start], np.int64)),
                  op.encode_tensor(f"{prefix}{name}_e", np.asarray([start + 2 * n_freqs], np.int64))]
        nodes.append(op.encode_node("Slice", ["spec", f"{prefix}{name}_s", f"{prefix}{name}_e",
                                              f"{prefix}spec_axis", f"{prefix}spec_step"], [name]))
        nodes.append(op.encode_node("Mul", [name, name], [name + "2"]))
    inits += [op.encode_tensor(f"{prefix}spec_axis", np.asarray([1], np.int64)),
              op.encode_tensor(f"{prefix}spec_step", np.asarray([2], np.int64))]
    nodes.append(op.encode_node("Add", ["re2", "im2"], ["power"]))
    nodes.append(op.encode_node("Transpose", ["power"], ["power_t"], perm=[0, 2, 1]))


def export_melspectrogram_onnx(path: str, apply_transform: bool = False):
    """Write the log-mel frontend as a standalone .onnx graph: input
    ``(batch, samples)`` float32 holding raw int16-range PCM, output
    ``(batch, frames, 32)`` log-mel dB (librosa power_to_db with the
    per-example top_db floor). With ``apply_transform`` the downstream
    ``spec/10 + 2`` affine is part of the graph, so the output feeds the
    embedding directly. The frame count follows ``samples``."""
    from openwakeword_tpu_torch.ops import melspec

    nodes, inits = [], []
    _stft_power_nodes(nodes, inits, np.asarray(melspec.stft_power_basis(), np.float64),
                      config.HOP_LENGTH, "", "dft_basis")
    # mel projection: (B, T, 257) @ (257, 32)
    inits.append(op.encode_tensor("mel_basis", np.asarray(melspec.mel_filterbank(), np.float32)))
    nodes.append(op.encode_node("MatMul", ["power_t", "mel_basis"], ["mel"]))

    # librosa power_to_db: 10*log10(max(mel, amin)) - 10*log10(max(amin, ref))
    inits.append(op.encode_tensor("amin", np.float32(config.MEL_AMIN).reshape(())))
    nodes.append(op.encode_node("Max", ["mel", "amin"], ["mel_c"]))
    nodes.append(op.encode_node("Log", ["mel_c"], ["mel_ln"]))
    inits.append(op.encode_tensor("db_scale", np.float32(10.0 / np.log(10.0)).reshape(())))
    nodes.append(op.encode_node("Mul", ["mel_ln", "db_scale"], ["mel_db"]))
    cur = "mel_db"
    ref_db = 10.0 * np.log10(max(config.MEL_AMIN, config.MEL_REF))
    if ref_db != 0.0:
        inits.append(op.encode_tensor("ref_db", np.float32(ref_db).reshape(())))
        nodes.append(op.encode_node("Sub", [cur, "ref_db"], ["mel_db_ref"]))
        cur = "mel_db_ref"
    if config.MEL_TOP_DB is not None:
        # a data-dependent floor over each example's whole spectrogram
        nodes.append(op.encode_node("ReduceMax", [cur], ["db_peak"], axes=[1, 2], keepdims=1))
        inits.append(op.encode_tensor("top_db", np.float32(config.MEL_TOP_DB).reshape(())))
        nodes.append(op.encode_node("Sub", ["db_peak", "top_db"], ["db_floor"]))
        nodes.append(op.encode_node("Max", [cur, "db_floor"], ["mel_db_clamped"]))
        cur = "mel_db_clamped"
    if apply_transform:
        inits += [op.encode_tensor("tf_scale", np.float32(config.MEL_TRANSFORM_SCALE).reshape(())),
                  op.encode_tensor("tf_shift", np.float32(config.MEL_TRANSFORM_SHIFT).reshape(()))]
        nodes.append(op.encode_node("Mul", [cur, "tf_scale"], ["mel_scaled"]))
        nodes.append(op.encode_node("Add", ["mel_scaled", "tf_shift"], ["melspectrogram"]))
    else:
        nodes.append(op.encode_node("Identity", [cur], ["melspectrogram"]))

    _write(path, op.encode_model(
        nodes, inits,
        inputs=[op.encode_value_info("input", ["batch", "samples"])],
        outputs=[op.encode_value_info("melspectrogram", ["batch", "frames", config.N_MELS])]))


def export_vad_onnx(params: Dict, path: str, frame_samples: int = 480):
    """Write a VAD network (``models.vad_net``) as an .onnx graph with the
    Silero I/O contract: inputs ``input (batch, frame)`` audio in [-1, 1],
    ``h`` / ``c`` ``(2, batch, 64)`` and an ignored ``sr`` scalar; outputs
    ``output (batch, 1)``, ``hn``, ``cn``. The frame length is fixed at
    export (480 serves the VAD's predict path, 640 its ``__call__``). The
    file loads back through the Silero importer (``models.silero``)."""
    from openwakeword_tpu_torch.models import vad_net

    if frame_samples < vad_net.MIN_SAMPLES:
        raise ValueError(f"frame_samples={frame_samples} is below the "
                         f"{vad_net.MIN_SAMPLES}-sample minimum (one STFT frame)")
    basis, melw = vad_net._frontend_consts_np()

    nodes, inits = [], []
    _stft_power_nodes(nodes, inits, basis, vad_net.HOP, "v", "vad_dft")
    inits.append(op.encode_tensor("vad_mel", np.asarray(melw, np.float32)))
    nodes.append(op.encode_node("MatMul", ["power_t", "vad_mel"], ["mel"]))
    inits.append(op.encode_tensor("log_eps", np.float32(1e-6).reshape(())))
    nodes.append(op.encode_node("Add", ["mel", "log_eps"], ["mel_eps"]))
    nodes.append(op.encode_node("Log", ["mel_eps"], ["feats"]))

    # projection to the LSTM width
    inits += [op.encode_tensor("proj_w", as_numpy(params["proj"]["w"])),
              op.encode_tensor("proj_b", as_numpy(params["proj"]["b"]))]
    nodes.append(op.encode_node("MatMul", ["feats", "proj_w"], ["proj_mm"]))
    nodes.append(op.encode_node("Add", ["proj_mm", "proj_b"], ["proj_lin"]))
    nodes.append(op.encode_node("Relu", ["proj_lin"], ["z_btd"]))
    nodes.append(op.encode_node("Transpose", ["z_btd"], ["z_tbd"], perm=[1, 0, 2]))

    hidden = vad_net.HIDDEN
    inits.append(op.encode_tensor("state_axis", np.asarray([0], np.int64)))
    xs = "z_tbd"
    h_outs, c_outs = [], []
    for layer in range(vad_net.LAYERS):
        w, r, b = _lstm_wrb(params[f"lstm{layer}"])
        inits += [
            op.encode_tensor(f"l{layer}_W", w[None]),
            op.encode_tensor(f"l{layer}_R", r[None]),
            op.encode_tensor(f"l{layer}_B", b[None]),
            op.encode_tensor(f"l{layer}_s", np.asarray([layer], np.int64)),
            op.encode_tensor(f"l{layer}_e", np.asarray([layer + 1], np.int64)),
        ]
        for state in ("h", "c"):
            nodes.append(op.encode_node("Slice", [state, f"l{layer}_s", f"l{layer}_e", "state_axis"],
                                        [f"l{layer}_{state}0"]))
        nodes.append(op.encode_node(
            "LSTM", [xs, f"l{layer}_W", f"l{layer}_R", f"l{layer}_B", "", f"l{layer}_h0", f"l{layer}_c0"],
            [f"l{layer}_Y", f"l{layer}_hn", f"l{layer}_cn"], hidden_size=hidden, direction="forward"))
        h_outs.append(f"l{layer}_hn")
        c_outs.append(f"l{layer}_cn")
        if layer < vad_net.LAYERS - 1:
            inits.append(op.encode_tensor(f"l{layer}_sq", np.asarray([1], np.int64)))
            nodes.append(op.encode_node("Squeeze", [f"l{layer}_Y", f"l{layer}_sq"], [f"l{layer}_out"]))
            xs = f"l{layer}_out"
    nodes.append(op.encode_node("Concat", h_outs, ["hn"], axis=0))
    nodes.append(op.encode_node("Concat", c_outs, ["cn"], axis=0))

    inits.append(op.encode_tensor("last_sq", np.asarray([0], np.int64)))
    nodes.append(op.encode_node("Squeeze", [h_outs[-1], "last_sq"], ["h_last"]))
    inits += [op.encode_tensor("out_w", as_numpy(params["out"]["w"])),
              op.encode_tensor("out_b", as_numpy(params["out"]["b"]))]
    nodes.append(op.encode_node("Gemm", ["h_last", "out_w", "out_b"], ["logit"]))
    nodes.append(op.encode_node("Sigmoid", ["logit"], ["output"]))

    _write(path, op.encode_model(
        nodes, inits,
        inputs=[op.encode_value_info("input", ["batch", frame_samples]),
                op.encode_value_info("h", [2, "batch", hidden]),
                op.encode_value_info("c", [2, "batch", hidden]),
                op.encode_value_info("sr", [], elem_type=op.TP_INT64)],
        outputs=[op.encode_value_info("output", ["batch", 1]),
                 op.encode_value_info("hn", [2, "batch", hidden]),
                 op.encode_value_info("cn", [2, "batch", hidden])]))


def export_embedding_onnx(params: Dict, path: str):
    """Write the speech-embedding CNN as a standalone .onnx graph: input
    ``(batch, 76, 32, 1)`` NHWC transformed log-mel window, output
    ``(batch, 1, 1, 96)``. Emits the unfolded form, explicit
    BatchNormalization nodes (epsilon 1e-3) and the clipped-leaky
    activation ``max(max(0.2x, x), -0.4)`` as Mul/Max ops, which
    ``io.onnx_import.import_embedding_onnx`` reads back exactly.

    ``params`` must be unfolded (conv_i: {w} OIHW and bn_i statistics), as
    ``convert.embedding_from_jax`` gives them from a checkpoint."""
    from openwakeword_tpu_torch.models import embedding

    if embedding.is_folded(params):
        raise ValueError("export_embedding_onnx needs UNFOLDED params "
                         "(conv_i/bn_i form); BN-folded params cannot be "
                         "unfolded back into BatchNormalization nodes")

    nodes, inits = [], []
    counter = [0]

    def t(name):
        counter[0] += 1
        return f"e{counter[0]}_{name}"

    nodes.append(op.encode_node("Transpose", ["input_window"], ["x_nchw"], perm=[0, 3, 1, 2]))
    cur = "x_nchw"
    h, w = embedding.INPUT_SHAPE[:2]
    pending_pad = (0, 0)
    conv_i = bn_i = 0
    for layer in embedding.spec():
        kind = layer[0]
        if kind == "pad":
            pending_pad = layer[1]
        elif kind == "conv":
            _, _, (kh, kw), padding, act = layer
            ph, pw = ((kh - 1), (kw - 1)) if padding == "SAME" else (0, 0)   # stride 1: total pad k - 1
            ph, pw = ph + 2 * pending_pad[0], pw + 2 * pending_pad[1]
            pending_pad = (0, 0)
            wn = f"conv{conv_i}_w"
            inits.append(op.encode_tensor(wn, np.ascontiguousarray(as_numpy(params[f"conv_{conv_i}"]["w"]))))
            out = t(f"conv{conv_i}")
            nodes.append(op.encode_node("Conv", [cur, wn], [out],
                                        pads=[ph // 2, pw // 2, ph - ph // 2, pw - pw // 2]))
            h, w = h + ph - (kh - 1), w + pw - (kw - 1)
            cur = out
            if act == "relu":
                out = t("relu")
                nodes.append(op.encode_node("Relu", [cur], [out]))
                cur = out
            conv_i += 1
        elif kind == "bnact":
            bn = params[f"bn_{bn_i}"]
            names = []
            for field in ("gamma", "beta", "mean", "var"):
                nm = f"bn{bn_i}_{field}"
                inits.append(op.encode_tensor(nm, as_numpy(bn[field])))
                names.append(nm)
            out = t(f"bn{bn_i}")
            nodes.append(op.encode_node("BatchNormalization", [cur] + names, [out],
                                        epsilon=float(embedding.BN_EPS)))
            # clipped leaky: max(max(0.2*x, x), -0.4)
            leak = t("leak")
            nodes.append(op.encode_node("Mul", [out, "leak_slope"], [leak]))
            lo = t("leaky")
            nodes.append(op.encode_node("Max", [leak, out], [lo]))
            out2 = t("clip")
            nodes.append(op.encode_node("Max", [lo, "leak_floor"], [out2]))
            cur = out2
            bn_i += 1
        elif kind == "pool":
            _, window, strides, padding = layer
            if padding == "SAME":
                tot = [max(0, (-(-d // s) - 1) * s + k - d) for d, k, s in zip((h, w), window, strides)]
                pads = [tot[0] // 2, tot[1] // 2, tot[0] - tot[0] // 2, tot[1] - tot[1] // 2]
                h, w = -(-h // strides[0]), -(-w // strides[1])
            else:
                pads = [0, 0, 0, 0]
                h = (h - window[0]) // strides[0] + 1
                w = (w - window[1]) // strides[1] + 1
            out = t("pool")
            nodes.append(op.encode_node("MaxPool", [cur], [out], kernel_shape=list(window),
                                        strides=list(strides), pads=pads))
            cur = out
    inits += [op.encode_tensor("leak_slope", np.float32(0.2).reshape(())),
              op.encode_tensor("leak_floor", np.float32(-0.4).reshape(()))]
    if (h, w) != (1, 1):
        raise AssertionError(f"embedding export shape tracking ended at {(h, w)}, "
                             "expected (1, 1) -- layer spec changed?")

    # (B, 96, 1, 1) NCHW -> the artifact's (B, 1, 1, 96) NHWC output
    nodes.append(op.encode_node("Transpose", [cur], ["embedding"], perm=[0, 2, 3, 1]))
    _write(path, op.encode_model(
        nodes, inits,
        inputs=[op.encode_value_info("input_window", ["batch"] + list(embedding.INPUT_SHAPE))],
        outputs=[op.encode_value_info("embedding", ["batch", 1, 1, embedding.OUTPUT_DIM])]))
