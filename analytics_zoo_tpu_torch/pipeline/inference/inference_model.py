"""InferenceModel: thread-safe inference holder.

Counterpart of ``analytics_zoo_tpu/pipeline/inference/inference_model.py``
(parity: ``InferenceModel.scala:30`` — a blocking queue of model copies
bounding concurrent predicts, ``doPredict`` :622-656, ``retrieveModel``
:710). As in the JAX package the model's weights are shared and the
queue holds concurrency permits, not copies.

This slice ports the float path of a native Keras model
(``load_keras_net``). Quantised models, the foreign-format loaders and
calibration arrive with later slices.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..api.keras.engine.topology import as_device_tensor


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
        self.model = model.to(self.device).eval()
        self._graph = model.graph_function()

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

    def load_keras_net(self, net, device=None, quantize: bool = False):
        """Load an in-memory KerasNet onto ``device`` — the context's
        device when None, which is ``cuda:0`` unless the context was made
        for another device. The model moves there in place."""
        if quantize:
            raise NotImplementedError(
                "quantised inference is not ported yet; it arrives with "
                "the quantisation slice of the port")
        self._install(FloatModel(net, device=device))
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
