"""InferenceModel: thread-safe inference holder.

Counterpart of ``analytics_zoo_tpu/pipeline/inference/inference_model.py``
(parity: ``InferenceModel.scala:30`` — a blocking queue of model copies
bounding concurrent predicts, ``doPredict`` :622-656, ``retrieveModel``
:710). As in the JAX package the model's weights are shared and the
queue holds concurrency permits, not copies.

A native Keras model loads in float32 (``load_keras_net`` on a model in
memory; ``load``, ``load_bigdl``, ``do_load`` on a directory that
``save_model`` wrote, a ``KerasNet``'s or a zoo model's, by either
package) or as int8 (:class:`QuantizedModel`: ``load_keras_net(
quantize=True, calibration=, scales=)``, ``load_quantized`` /
``do_load_openvino``, ``calibrate``, ``save_calibration``,
``load_calibration``; the calibration files are the JAX package's). The
foreign-format loaders (TF, TorchScript, Caffe, ONNX) are not ported.

``predict_async`` returns the outputs on the model's device.
:class:`HostCopy` starts their copy to the host without waiting; its
``wait`` is the one point that waits for that batch's work: the Cluster
Serving loop dispatches a batch, starts its copy, and its writer thread
waits on that copy alone.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...ops import quant
from ..engine import as_device_tensor


class HostCopy:
    """Outputs of one dispatch on their way to host memory.

    For CUDA tensors the copy goes into pinned host memory, issued
    without blocking on the current stream, followed by a recorded
    ``torch.cuda.Event``: ``wait`` then blocks on that event alone, so
    it covers this dispatch's kernels and copy and not the work queued
    after it on the same stream (``.cpu()`` would wait for that too).
    Half-precision outputs become float32 on the card before the copy.
    CPU tensors and host arrays are taken as they are."""

    def __init__(self, out):
        self._multi = isinstance(out, (list, tuple))
        outs = list(out) if self._multi else [out]
        self._event = None
        with torch.inference_mode():
            self._host = [self._start(o) for o in outs]
        if any(isinstance(o, torch.Tensor) and o.device.type == "cuda"
               for o in outs):
            self._event = torch.cuda.Event()
            self._event.record()

    @staticmethod
    def _start(o):
        if not isinstance(o, torch.Tensor) or o.device.type != "cuda":
            return o
        if o.dtype in (torch.float16, torch.bfloat16):
            o = o.float()
        host = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
        host.copy_(o, non_blocking=True)
        return host

    def wait(self):
        """The outputs as numpy arrays (a list for a multi-output model),
        once this dispatch's copy has landed."""
        if self._event is not None:
            self._event.synchronize()
        out = [o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
               for o in self._host]
        return out if self._multi else out[0]


class AbstractModel:
    """One loaded backend: ``predict(inputs) -> outputs`` on host numpy."""

    def predict(self, inputs):
        raise NotImplementedError

    def predict_async(self, inputs):
        """Dispatch without forcing a host transfer of the outputs; the
        default is the synchronous path."""
        return self.predict(inputs)

    def release(self):
        pass


class FloatModel(AbstractModel):
    """A native zoo model (a ``KerasNet``) on one device.

    PyTorch runs eagerly: there is no per-input-signature compiled
    executable, so the JAX ``FloatModel``'s AOT cache (``_lookup``,
    ``cache_cap``) has no counterpart here. The forward is
    ``graph.apply(inputs, training=False)`` under
    ``torch.inference_mode()``."""

    def __init__(self, model, device=None):
        if device is None:
            from ...common.nncontext import get_nncontext
            device = get_nncontext().device
        self.device = torch.device(device)
        # a Sequential builds its weights (on the CPU) when its graph is
        # first asked for: build them before the move, or they stay behind
        self._graph = model.graph_function()
        self.model = model.to(self.device).eval()

    def _as_input_list(self, inputs):
        return [as_device_tensor(x, self.device)
                for x in (inputs if isinstance(inputs, (list, tuple))
                          else [inputs])]

    def predict(self, inputs):
        out = self.predict_async(inputs)
        if isinstance(out, (list, tuple)):
            return [o.cpu().numpy() for o in out]
        return out.cpu().numpy()

    def predict_async(self, inputs):
        """Launch the forward and return device tensors without waiting
        for the device; copying them to the host is the caller's
        synchronisation point."""
        with torch.inference_mode():
            return self._graph.apply(self._as_input_list(inputs),
                                     training=False)


class QuantizedModel(FloatModel):
    """int8 PTQ, three tiers (replacing OpenVINO int8,
    ``OpenVinoInferenceSupportive.scala:151-343``), as the JAX package's
    ``QuantizedModel``:

    - **weight-only** (construction): every kernel leaf (a parameter of
      two or more dims whose name holds one of ``KERNEL_KEYS``) is
      quantized int8 per output channel and dequantized at each call.
    - **activation-calibrated** (``calibrate(samples)``): an eager
      replay over a calibration set records per-kernel input AND output
      activation ranges, after which Dense/Conv products run ``int8 x
      int8 -> int32`` (``ops/quant.py``).
    - **requantization chains** (planned after calibration, or at load
      time from exported scales): consecutive quantized layers --
      possibly separated by int8-transparent layers (Flatten, Reshape,
      Permute, Dropout, relu, MaxPooling2D) -- exchange int8 directly.

    The caller's model is not changed: its float parameters stay as they
    are (it moves to ``device``, as ``FloatModel`` moves it), and the
    forward hands each eligible layer its QuantTensor through
    ``quant.layer_kernels``; a quantized kernel of a layer that does not
    route through ``quant.matmul``/``quant.conv2d`` reaches it
    dequantized through ``torch.func.functional_call``, which swaps that
    parameter for the call. ``chains`` lists ``(producer, consumer)``
    layer names; the calibration keys are the JAX param paths
    (``"['dense_1']['kernel']"``, outputs under ``...::out``), so either
    package loads the other's ``calibration.json``."""

    #: param leaf names treated as quantizable 2D+ kernels
    KERNEL_KEYS = ("kernel", "w", "qkv_w", "proj_w", "embedding")

    def __init__(self, model, device=None, calibration=None, scales=None):
        super().__init__(model, device)
        self._lock = threading.Lock()
        #: param path -> (parameter name on the model, QuantTensor)
        self._params: Dict[str, Tuple[str, quant.QuantTensor]] = \
            self._quantize_params()
        self._layer_of: Dict[str, object] = {}
        self._int8_paths = self._compute_eligible_paths()
        self.calibrated = False
        #: (producer_layer_name, consumer_layer_name) requant chains
        self.chains: List[Tuple[str, str]] = []
        self._scales: Dict[str, float] = {}
        self._publish(self._params)
        if scales is not None:
            self.load_calibration(scales)
        if calibration is not None:
            self.calibrate(calibration)

    @staticmethod
    def _path(param_name: str) -> str:
        return "".join(f"['{k}']" for k in param_name.split("."))

    def _quantize_params(self):
        out = {}
        for name, p in self.model.named_parameters():
            leaf = name.rsplit(".", 1)[-1].lower()
            if p.dim() >= 2 and any(k in leaf for k in self.KERNEL_KEYS):
                path = self._path(name)
                out[path] = (name, quant.quantize_weight(p, name=path)
                             .to(self.device))
        return out

    def _compute_eligible_paths(self) -> frozenset:
        """Kernels whose layer routes its product through
        ``quant.matmul``/``quant.conv2d``: exact types only (a subclass
        that overrides ``forward`` may not). ``SparseDense`` and
        ``ShareConvolution2D`` join when the port has them (ROADMAP
        A8)."""
        from ..api.keras.layers import (AtrousConvolution2D, Convolution2D,
                                        Dense)

        ok_types = (Dense, Convolution2D, AtrousConvolution2D)
        eligible = set()
        for layer in getattr(self._graph, "layers", ()):
            if type(layer) in ok_types:
                path = f"['{layer.name}']['kernel']"
                eligible.add(path)
                self._layer_of[path] = layer
        return frozenset(eligible)

    def _publish(self, params):
        """Install ``params``: the layer -> kernel mapping the forward
        hands the eligible layers, and the other quantized leaves."""
        kernels, others = {}, {}
        for path, (name, qt) in params.items():
            if path in self._int8_paths:
                kernels[self._layer_of[path]] = qt
            else:
                others[name] = qt
        self._params = params
        self._plan = (kernels, others)

    @property
    def kernels(self) -> Dict[str, "quant.QuantTensor"]:
        """Param path -> QuantTensor of every quantized kernel."""
        return {path: qt for path, (_, qt) in self._params.items()}

    def _forward(self, inputs):
        kernels, others = self._plan
        with quant.layer_kernels(kernels):
            if not others:
                return self._graph.apply(inputs, training=False)
            floats = {name: qt.dequantize() for name, qt in others.items()}
            return torch.func.functional_call(
                self.model, floats, (inputs,), dict(training=False))

    def predict_async(self, inputs):
        with torch.inference_mode():
            return self._forward(self._as_input_list(inputs))

    def calibrate(self, samples):
        """Record input AND output activation ranges over ``samples`` (a
        list of input lists or batches, or a single batched array) in an
        eager replay, switch eligible kernels to calibrated int8 compute,
        and plan requantization chains."""
        if isinstance(samples, (np.ndarray, torch.Tensor)):
            samples = [samples]
        with quant.calibrating() as ranges, torch.inference_mode():
            for s in samples:
                self._forward(self._as_input_list(s))
        self._apply_scales(quant.calibration_scales(ranges))
        return self

    def load_calibration(self, scales: Dict[str, float]):
        """Apply previously exported calibration scales (the output of
        :meth:`export_calibration`): chains are planned from the stored
        scales with no replay."""
        self._apply_scales({str(k): float(v) for k, v in scales.items()})
        return self

    def export_calibration(self) -> Dict[str, float]:
        """Kernel-path-keyed activation scales (inputs under the kernel
        path, outputs under ``<path>::out``), JSON-serializable."""
        return dict(self._scales)

    def _apply_scales(self, scales: Dict[str, float]):
        params = {}
        for path, (name, qt) in self._params.items():
            if path in scales and path in self._int8_paths and \
                    qt.q.dim() in (2, 4):
                # drop any stale chain plan / folded bias: _plan_chains
                # and _fold_biases rebuild them from the fresh scales
                qt = qt.with_requant(None).with_qbias(None) \
                    .with_act_scale(scales[path])
                out = scales.get(quant.out_key(path))
                if out is not None:
                    qt = qt.with_out_scale(out)
            params[path] = (name, qt)
        with self._lock:
            self._fold_biases(params)
            self.chains = self._plan_chains(params)
            self._scales = dict(scales)
            self._publish(params)
            self.calibrated = True

    def _calibrated_kernel(self, params, layer):
        """The layer's calibrated int8-compute QuantTensor, or None when
        the layer is not on the int8 path."""
        path = f"['{layer.name}']['kernel']"
        if path not in self._int8_paths:
            return None
        qt = params[path][1]
        return qt if qt.act_scale is not None and qt.q.dim() in (2, 4) \
            else None

    def _fold_biases(self, params):
        """Pre-quantize every calibrated layer's bias into the int32
        accumulator domain (``round(bias / (act_scale * w_scale))``, in
        float64 numpy as the JAX package computes it) so the forward adds
        a constant int32 vector instead of dividing."""
        for path in self._int8_paths:
            layer = self._layer_of[path]
            qt = self._calibrated_kernel(params, layer)
            if qt is None or not getattr(layer, "use_bias", False):
                continue
            combined = float(qt.act_scale) * \
                qt.scale.cpu().numpy().astype(np.float64).reshape(-1)
            bias = layer.bias.detach().cpu().numpy().astype(np.float64)
            qb = np.clip(np.round(bias / combined), -(2 ** 31) + 1,
                         2 ** 31 - 1)
            params[path] = (params[path][0], qt.with_qbias(qb))

    # -- requantization-chain planner ----------------------------------
    @staticmethod
    def _int8_transparent(layer) -> bool:
        """Layers an int8 activation can flow through unchanged in value
        semantics: pure reshapes/transposes, inference-mode dropout,
        relu (commutes with the positive scale), and max-pooling
        (selects, never mixes). Exact types only -- AveragePooling2D
        subclasses MaxPooling2D but averages."""
        from ..api.keras.layers import (Activation, Dropout, Flatten,
                                        MaxPooling2D)

        # Reshape and Permute join when the port has them (ROADMAP A8)
        if type(layer) in (Flatten, Dropout, MaxPooling2D):
            return True
        if type(layer) is Activation:
            return getattr(layer.fn, "name", None) == "relu"
        return False

    def _plan_chains(self, params):
        """Walk the graph: for every calibrated quantized layer whose
        single consumer (across int8-transparent layers) is another
        calibrated quantized layer, precompute the int32 -> int8
        requantize multiplier ``act_scale * w_scale /
        consumer_act_scale`` and store it on the producer kernel."""
        graph = self._graph
        consumers: Dict[int, list] = {}
        for node in graph.nodes:
            for v in node.inputs:
                if v.node is not None:
                    consumers.setdefault(v.node.id, []).append(node)
        output_ids = {v.node.id for v in graph.outputs
                      if v.node is not None}
        # a layer used by >1 node shares ONE kernel; a per-consumer
        # requant multiplier cannot live on it
        counts: Dict[int, int] = {}
        for n in graph.nodes:
            counts[id(n.layer)] = counts.get(id(n.layer), 0) + 1
        shared = {lid for lid, c in counts.items() if c > 1}

        def chain_target(node):
            cur = node
            while True:
                if cur.id in output_ids:
                    return None  # model outputs must stay f32
                cons = consumers.get(cur.id, [])
                if len(cons) != 1 or len(cons[0].inputs) != 1:
                    return None  # fan-out / merges stay f32
                nxt = cons[0]
                if self._calibrated_kernel(params, nxt.layer) is not None:
                    return None if id(nxt.layer) in shared else nxt
                if not self._int8_transparent(nxt.layer):
                    return None
                cur = nxt

        chains = []
        for node in graph.nodes:
            qt = self._calibrated_kernel(params, node.layer)
            if qt is None or qt.requant is not None or \
                    id(node.layer) in shared:
                continue
            if not quant._chainable_act(
                    getattr(node.layer, "activation", None)):
                continue
            target = chain_target(node)
            if target is None:
                continue
            tgt = self._calibrated_kernel(params, target.layer)
            path = f"['{node.layer.name}']['kernel']"
            params[path] = (params[path][0], qt.with_requant(
                quant.chain_requant(qt.act_scale, qt.scale,
                                    tgt.act_scale)))
            chains.append((node.layer.name, target.layer.name))
        return chains

    def param_bytes(self) -> Dict[str, int]:
        """Bytes of the model's float32 parameters, and of its weights as
        this model computes with them: the int8 kernels with their scales
        and the parameters that stay float32."""
        total = sum(p.numel() * p.element_size()
                    for p in self.model.parameters())
        quantized = {name for name, _ in self._params.values()}
        kept = sum(p.numel() * p.element_size()
                   for n, p in self.model.named_parameters()
                   if n not in quantized)
        int8 = sum(qt.nbytes() for _, qt in self._params.values())
        return {"float32": total, "int8": int8 + kept}


class InferenceModel:
    """Thread-safe inference holder with bounded concurrency + autoscale.

    ``supported_concurrent_num``: number of concurrent predicts admitted
    (the reference's model-copy count, InferenceModel.scala:30,67); 0 or
    less grants a new permit whenever all are taken."""

    def __init__(self, supported_concurrent_num: int = 1):
        self.supported_concurrent_num = int(supported_concurrent_num)
        self.model: Optional[AbstractModel] = None
        self._permits: "queue.Queue" = queue.Queue()
        self._autoscale = self.supported_concurrent_num <= 0
        self._granted = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    # loaders (doLoad* parity)
    # ------------------------------------------------------------------
    def _install(self, model: AbstractModel):
        self.model = model
        self._permits = queue.Queue()
        n = max(self.supported_concurrent_num, 1)
        for _ in range(n):
            self._permits.put(object())
        self._granted = n

    @staticmethod
    def _resolve_model_dir(model_path: str) -> str:
        """A zoo-model directory (``ZooModel.save_model``: zoo_model.pkl
        and a ``keras/`` subdirectory) resolves to its Keras model's."""
        if os.path.exists(os.path.join(model_path, "zoo_model.pkl")):
            return os.path.join(model_path, "keras")
        return model_path

    def load(self, model_path: str, weight_path: Optional[str] = None,
             device=None):
        """Load a saved model directory (doLoad parity): a ``KerasNet``'s
        ``save_model`` directory or a zoo model's, onto ``device`` (the
        context's when None, ``cuda:0`` unless the context was made for
        another device)."""
        from ..api.keras.models import KerasNet

        self._install(FloatModel(
            KerasNet.load_model(self._resolve_model_dir(model_path)),
            device=device))
        return self

    load_bigdl = load
    do_load = load

    def load_keras_net(self, net, device=None, quantize: bool = False,
                       calibration=None, scales=None):
        """Load an in-memory KerasNet (or a zoo model's) onto ``device`` —
        the context's device when None, which is ``cuda:0`` unless the
        context was made for another device. The model moves there in
        place. ``quantize`` loads it as int8 (weight-only);
        ``calibration`` (sample inputs) or ``scales`` (exported
        calibration scales, a dict) make it calibrated int8 compute with
        its requantization chains and imply ``quantize``."""
        if hasattr(net, "model") and not hasattr(net, "graph_function"):
            net = net.model
        if quantize or calibration is not None or scales is not None:
            self._install(QuantizedModel(net, device=device,
                                         calibration=calibration,
                                         scales=scales))
        else:
            self._install(FloatModel(net, device=device))
        return self

    def calibrate(self, samples):
        """Activation-calibrate a loaded quantized model
        (doCalibrate / calibrateTensorflowModel parity)."""
        if not isinstance(self.model, QuantizedModel):
            raise RuntimeError("calibrate() needs a quantized model "
                               "(load with quantize=True)")
        self.model.calibrate(samples)
        return self

    #: file name probed for exported calibration scales inside a model
    #: directory (written by :meth:`save_calibration`)
    CALIBRATION_FILE = "calibration.json"

    def load_quantized(self, model_path: str,
                       calibration_path: Optional[str] = None,
                       device=None):
        """int8 PTQ of a saved model directory (the doLoadOpenVINO int8
        IR's counterpart). ``calibration_path`` (or a
        ``calibration.json`` saved next to the model) supplies exported
        activation scales, so the requantization chains are planned at
        load time with no calibration replay."""
        from ..api.keras.models import KerasNet

        model_dir = self._resolve_model_dir(model_path)
        if calibration_path is None:
            default = os.path.join(model_dir, self.CALIBRATION_FILE)
            if os.path.exists(default):
                calibration_path = default
        scales = None
        if calibration_path is not None:
            with open(calibration_path) as f:
                scales = json.load(f)
        self._install(QuantizedModel(KerasNet.load_model(model_dir),
                                     device=device, scales=scales))
        return self

    do_load_openvino = load_quantized

    def save_calibration(self, path: str):
        """Persist the loaded quantized model's calibration scales
        (JSON): point ``load_quantized(calibration_path=...)`` back at
        it, or drop it in the model directory as ``calibration.json``."""
        if not isinstance(self.model, QuantizedModel) or \
                not self.model.calibrated:
            raise RuntimeError("save_calibration() needs a calibrated "
                               "quantized model")
        with open(path, "w") as f:
            json.dump(self.model.export_calibration(), f, indent=2)
        return self

    def load_calibration(self, scales):
        """Apply exported calibration scales (a dict or a JSON path) to
        the loaded quantized model."""
        if not isinstance(self.model, QuantizedModel):
            raise RuntimeError("load_calibration() needs a quantized "
                               "model (load with quantize=True)")
        if isinstance(scales, str):
            with open(scales) as f:
                scales = json.load(f)
        self.model.load_calibration(scales)
        return self

    # ------------------------------------------------------------------
    # predict (doPredict :622-656 + retrieveModel :710)
    # ------------------------------------------------------------------
    def _acquire(self):
        if self._autoscale:
            try:
                return self._permits.get_nowait()
            except queue.Empty:
                with self._lock:
                    self._granted += 1
                return object()
        return self._permits.get()

    def predict(self, inputs):
        if self.model is None:
            raise RuntimeError("no model loaded; call load*() first")
        permit = self._acquire()
        try:
            return self.model.predict(inputs)
        finally:
            self._permits.put(permit)

    def predict_async(self, inputs):
        """Permit-guarded dispatch: returns device tensors. The permit is
        released at dispatch; the host copy is the caller's
        synchronisation point."""
        if self.model is None:
            raise RuntimeError("no model loaded; call load*() first")
        permit = self._acquire()
        try:
            return self.model.predict_async(inputs)
        finally:
            self._permits.put(permit)

    def warm(self, shape, bucket_sizes, dtype=np.float32) -> Dict[int, float]:
        """Run one synthetic predict per batch size before traffic.

        ``shape`` is the per-record tensor shape, or a list of shapes for
        a multi-input model; each ``bucket_sizes`` entry becomes one
        all-zeros ``(bucket,) + shape`` predict (on the GPU this also
        builds and loads the kernels). Returns {bucket: seconds} and
        raises on the first failure."""
        if self.model is None:
            raise RuntimeError("no model loaded; call load*() first")
        multi = isinstance(shape, list)
        shapes = [tuple(int(s) for s in sh) for sh in
                  (shape if multi else [shape])]
        times: Dict[int, float] = {}
        for b in sorted({int(x) for x in bucket_sizes}):
            xs = [np.zeros((b,) + sh, dtype) for sh in shapes]
            t0 = time.perf_counter()
            self.predict(xs if multi else xs[0])
            times[b] = time.perf_counter() - t0
        return times

    def release(self):
        if self.model is not None:
            self.model.release()
            self.model = None

    @property
    def concurrent_num(self):
        return self._granted
