"""InferenceModel: thread-safe inference holder.

Counterpart of ``analytics_zoo_tpu/pipeline/inference/inference_model.py``
(parity: ``InferenceModel.scala:30`` — a blocking queue of model copies
bounding concurrent predicts, ``doPredict`` :622-656, ``retrieveModel``
:710). As in the JAX package the model's weights are shared and the
queue holds concurrency permits, not copies.

The float path of a native Keras model is ported: ``load_keras_net`` on a
model in memory, and ``load`` (``load_bigdl``, ``do_load``) on a
directory that ``save_model`` wrote, a ``KerasNet``'s or a zoo model's,
by either package. Quantised models, the foreign-format loaders and
calibration arrive with later slices (ROADMAP A10).

``predict_async`` returns the outputs on the model's device.
:class:`HostCopy` starts their copy to the host without waiting; its
``wait`` is the one point that waits for that batch's work: the Cluster
Serving loop dispatches a batch, starts its copy, and its writer thread
waits on that copy alone.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

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

    def load_keras_net(self, net, device=None, quantize: bool = False):
        """Load an in-memory KerasNet (or a zoo model's) onto ``device`` —
        the context's device when None, which is ``cuda:0`` unless the
        context was made for another device. The model moves there in
        place."""
        if hasattr(net, "model") and not hasattr(net, "graph_function"):
            net = net.model
        if quantize:
            raise NotImplementedError(
                "quantised inference is not ported yet; it arrives with "
                "the quantisation slice of the port")
        self._install(FloatModel(net, device=device))
        return self

    def load_quantized(self, model_path: str,
                       calibration_path: Optional[str] = None, **kw):
        """The int8 loader of the JAX package; the port has no quantised
        backend yet."""
        raise NotImplementedError(
            "quantised inference (load_quantized) is not ported yet "
            "(ROADMAP A10)")

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
