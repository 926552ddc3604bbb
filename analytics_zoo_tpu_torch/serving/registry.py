"""ModelRegistry: versioned multi-model control plane for Cluster Serving.

Counterpart of ``analytics_zoo_tpu/serving/registry.py``, copied over the
port's ``InferenceModel`` (the default loader is its ``load`` of a saved
model's or zoo model's directory) and ``utils/file_io.py``; the manifest
is the JAX package's. An int8 version (``deploy(quantize=True)``, or a
pre-loaded quantized model) loads through ``load_quantized`` with its
calibration scales, and ``recover`` reloads it as int8.

The reference binds one serving process to one ``InferenceModel``
(ClusterServing.scala:44-392) — updating a model means restarting the
service.  This module is the control plane above the pipelined engine
(docs/serving-pipeline.md): named models, each with immutable numbered
versions wrapping an :class:`InferenceModel` loaded through the existing
multi-backend loaders, a routing pointer per model that can be swapped
atomically while traffic flows, and a canary mode that splits traffic by
a deterministic hash of the record uri.

Lifecycle (docs/model-registry.md):

- :meth:`ModelRegistry.deploy` — load + warm the new version *off*
  the serve path, then atomically swap the routing pointer and drain
  in-flight batches on the old version; a failed warmup/compile rolls
  back automatically (the pointer never moves).
- :meth:`ModelRegistry.set_canary` — route ``weight`` of a model's
  default traffic to a candidate version, keyed by ``crc32(uri)`` so a
  given uri always lands on the same side; the canary auto-rolls-back
  when its error rate exceeds ``error_threshold`` after
  ``min_requests`` observations.
- :meth:`ModelRegistry.promote` / :meth:`ModelRegistry.undeploy` —
  graduate a canary (or any ready version) to active / retire versions.

The deployed set persists as a JSON manifest written atomically through
``utils.file_io`` (:func:`~analytics_zoo_tpu_torch.utils.file_io.
write_bytes_atomic`), so a restarted server :meth:`recover`\\ s its
models, active pointers, and canary state.

``RegistryControlServer`` + :func:`control_request` are the file-RPC
bridge the ``zoo-serving deploy``/``undeploy``/``promote`` CLI verbs use
to drive a *running* server: requests are JSON files atomically renamed
into ``<root>/control/``, answered in place by the server's poll thread.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional

from ..pipeline.inference import InferenceModel
from ..pipeline.inference.inference_summary import InferenceSummary
from ..utils import file_io

logger = logging.getLogger("analytics_zoo_tpu_torch.serving.registry")

DEFAULT_MODEL = "default"


class RegistryError(RuntimeError):
    """Base class for registry control-plane failures."""


class UnknownModelError(RegistryError):
    """Routing asked for a model/version the registry does not hold."""


class DeployError(RegistryError):
    """Deploy failed (load/warmup/compile); the routing pointer was not
    moved — the previous version keeps serving."""


def _is_int8(model: Optional[InferenceModel]) -> bool:
    """Whether a pre-loaded InferenceModel carries an int8 backend."""
    from ..pipeline.inference.inference_model import QuantizedModel

    return model is not None and \
        isinstance(getattr(model, "model", None), QuantizedModel)


class ModelVersion:
    """One immutable numbered version of a named model.

    Holds the loaded :class:`InferenceModel` (or just a ``path`` while
    cold), its own :class:`InferenceSummary`, request/error counters,
    and an in-flight refcount used to drain dispatched batches before a
    retired version is released.
    """

    def __init__(self, name: str, version: int,
                 model: Optional[InferenceModel] = None,
                 path: Optional[str] = None, dtype: str = "f32",
                 calibration: Optional[str] = None):
        self.name = name
        self.version = int(version)
        self.model = model
        self.path = path
        #: compute dtype of this version ("f32" | "int8") — part of the
        #: dispatch key so an int8 canary never shares a batch with its
        #: f32 baseline
        self.dtype = dtype or "f32"
        #: exported calibration-scales path for int8 versions (enables
        #: requantization-chain planning at (re)load time)
        self.calibration = calibration
        #: registered -> warming -> ready -> retired | failed | cold
        self.state = "registered"
        self.created = time.time()
        self.summary = InferenceSummary()
        self.requests = 0
        self.errors = 0
        self._inflight = 0
        self._cv = threading.Condition()

    @property
    def key(self) -> str:
        return f"{self.name}:v{self.version}"

    # -- in-flight batch refcount (hot-swap drain) ---------------------
    def acquire(self):
        with self._cv:
            self._inflight += 1

    def release(self):
        with self._cv:
            self._inflight = max(self._inflight - 1, 0)
            self._cv.notify_all()

    @property
    def inflight(self) -> int:
        with self._cv:
            return self._inflight

    def drain(self, timeout: float = 10.0) -> bool:
        """Block until every dispatched batch on this version has been
        written (or ``timeout``); returns True when fully drained."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(timeout=remaining)
        return True

    def stats(self) -> dict:
        return {"state": self.state,
                "path": self.path,
                "dtype": self.dtype,
                "created": self.created,
                "requests": self.requests,
                "errors": self.errors,
                "inflight": self.inflight,
                "stages": self.summary.snapshot()["stages"]}


class CanaryState:
    """Traffic split for one model: ``weight`` of default-routed records
    go to ``version``; counters feed the auto-rollback check."""

    def __init__(self, version: int, weight: float,
                 error_threshold: float = 0.5, min_requests: int = 20):
        self.version = int(version)
        self.weight = min(max(float(weight), 0.0), 1.0)
        self.error_threshold = float(error_threshold)
        self.min_requests = int(min_requests)
        self.requests = 0
        self.errors = 0

    def stats(self) -> dict:
        return {"version": self.version, "weight": self.weight,
                "error_threshold": self.error_threshold,
                "min_requests": self.min_requests,
                "requests": self.requests, "errors": self.errors}


class ModelRegistry:
    """Named models, immutable numbered versions, atomic routing swaps.

    ``root``: directory (URI) for the persisted manifest; ``None`` keeps
    the registry in-memory only.  ``loader``: ``path -> InferenceModel``
    (defaults to :meth:`InferenceModel.load`, which accepts native zoo
    model directories; any of the multi-backend ``load_*`` loaders can
    be closed over instead).
    """

    MANIFEST = "manifest.json"

    def __init__(self, root: Optional[str] = None,
                 default_model: str = DEFAULT_MODEL,
                 loader: Optional[Callable[[str], InferenceModel]] = None,
                 canary_error_threshold: float = 0.5,
                 canary_min_requests: int = 20):
        self.root = root
        self.default_model = default_model
        self._loader = loader or self._default_loader
        self.canary_error_threshold = float(canary_error_threshold)
        self.canary_min_requests = int(canary_min_requests)
        self._lock = threading.RLock()
        self._models: Dict[str, Dict[int, ModelVersion]] = {}
        self._active: Dict[str, int] = {}
        self._canary: Dict[str, CanaryState] = {}
        self.events: deque = deque(maxlen=64)
        if root:
            file_io.makedirs(root)

    @staticmethod
    def _default_loader(path: str) -> InferenceModel:
        return InferenceModel().load(path)

    @property
    def manifest_uri(self) -> Optional[str]:
        if not self.root:
            return None
        return self.root.rstrip("/") + "/" + self.MANIFEST

    def _event(self, msg: str):
        logger.info("registry: %s", msg)
        self.events.append({"t": time.time(), "msg": msg})

    # ------------------------------------------------------------------
    # deploy / promote / undeploy / canary
    # ------------------------------------------------------------------
    def deploy(self, name: Optional[str] = None,
               model: Optional[InferenceModel] = None,
               path: Optional[str] = None,
               warmup: Optional[Callable[[InferenceModel], object]] = None,
               activate: bool = True, load: bool = True,
               drain_timeout: float = 10.0, quantize: bool = False,
               calibration: Optional[str] = None) -> ModelVersion:
        """Register the next version of ``name`` and (optionally) swap
        traffic onto it.

        The model is loaded (``path`` through ``loader``) and warmed
        (``warmup(model)`` — typically running every padding
        bucket) entirely off the serve path; only then does the routing
        pointer swap, after which the old version's in-flight batches
        drain.  Any load/warmup failure raises :class:`DeployError` and
        leaves routing untouched.  ``load=False`` records the version in
        the manifest without loading (offline deploy; the next
        :meth:`recover` loads it).

        ``quantize`` deploys the version as int8: loaded through
        :meth:`InferenceModel.load_quantized` with ``calibration``
        (exported scales JSON; defaults to a ``calibration.json`` inside
        the model directory), so requantization chains are planned at
        load time. The version carries ``dtype="int8"`` -- its own
        dispatch key, distinct from any f32 version, so an int8 build can
        canary side by side against its f32 baseline. A pre-loaded
        quantized ``model`` is recorded as int8 too.
        """
        name = name or self.default_model
        if model is None and path is None:
            raise ValueError("deploy needs a loaded model or a path")
        dtype = "int8" if quantize or _is_int8(model) else "f32"
        with self._lock:
            versions = self._models.setdefault(name, {})
            version = max(versions, default=0) + 1
            mv = ModelVersion(name, version, model=model, path=path,
                              dtype=dtype, calibration=calibration)
            versions[version] = mv
        if not load:
            if activate:
                with self._lock:
                    self._active[name] = version
            self._event(f"registered {mv.key} [{mv.dtype}] (path={path}; "
                        f"loads on next start)")
            self._save()
            return mv
        phase = "load"
        try:
            if mv.model is None:
                mv.model = self._load_version(mv)
            mv.state = "warming"
            phase = "warmup"
            if warmup is not None:
                warmup(mv.model)
        except Exception as e:
            with self._lock:
                mv.state = "failed"
                mv.model = None
            self._event(f"deploy of {mv.key} failed ({e}); routing "
                        f"pointer unchanged")
            self._save()
            raise DeployError(
                f"deploy of {mv.key} failed during {phase}: {e}") from e
        mv.state = "ready"
        if activate:
            self.promote(name, version, drain_timeout=drain_timeout)
        else:
            self._event(f"deployed {mv.key} (not routed)")
            self._save()
        return mv

    def _load_version(self, mv: ModelVersion) -> InferenceModel:
        """Load a version with its recorded dtype: int8 versions go
        through the quantized loader (+ calibration scales when
        exported), f32 through the configured loader."""
        if mv.dtype == "int8":
            return InferenceModel().load_quantized(
                mv.path, calibration_path=mv.calibration)
        return self._loader(mv.path)

    def _ensure_loaded(self, mv: ModelVersion,
                       warmup: Optional[Callable] = None):
        if mv.model is not None:
            return
        if not mv.path:
            raise RegistryError(
                f"{mv.key} has no loaded model and no path to load from")
        mv.state = "warming"
        try:
            mv.model = self._load_version(mv)
            if warmup is not None:
                warmup(mv.model)
        except Exception as e:
            mv.state = "failed"
            mv.model = None
            raise DeployError(f"loading {mv.key} failed: {e}") from e

    def promote(self, name: str, version: int,
                warmup: Optional[Callable] = None, load: bool = True,
                drain_timeout: float = 10.0) -> ModelVersion:
        """Atomically point ``name``'s routing at ``version`` (loading a
        cold version first, off the serve path), clear any canary on it,
        and drain in-flight batches on the previously active version."""
        with self._lock:
            versions = self._models.get(name)
            mv = versions.get(int(version)) if versions else None
            if mv is None:
                raise UnknownModelError(
                    f"unknown version {name}:v{version}")
        if load:
            self._ensure_loaded(mv, warmup=warmup)
        with self._lock:
            old_v = self._active.get(name)
            self._active[name] = mv.version
            if load:
                mv.state = "ready"
            can = self._canary.get(name)
            if can is not None and can.version == mv.version:
                del self._canary[name]
            old = None
            if old_v is not None and old_v != mv.version:
                old = versions.get(old_v)
        if old is not None:
            drained = old.drain(drain_timeout)
            old.state = "retired"
            self._event(f"{name}: v{old_v} -> v{mv.version} "
                        f"(old drained={drained})")
        else:
            self._event(f"{name}: active -> v{mv.version}")
        self._save()
        return mv

    def rollback(self, name: str, drain_timeout: float = 10.0
                 ) -> ModelVersion:
        """Point routing back at the newest loaded non-active version."""
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise UnknownModelError(f"unknown model {name!r}")
            active = self._active.get(name)
            candidates = [v for v in sorted(versions, reverse=True)
                          if v != active and
                          versions[v].model is not None and
                          versions[v].state != "failed"]
            if not candidates:
                raise RegistryError(
                    f"no loaded version of {name!r} to roll back to")
        return self.promote(name, candidates[0],
                            drain_timeout=drain_timeout)

    def undeploy(self, name: str, version: Optional[int] = None,
                 drain_timeout: float = 10.0) -> List[int]:
        """Remove one version (refusing the active one while siblings
        remain) or, with ``version=None``, the whole model.  Removed
        versions drain their in-flight batches before release."""
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise UnknownModelError(f"unknown model {name!r}")
            if version is None:
                targets = list(versions.values())
                del self._models[name]
                self._active.pop(name, None)
                self._canary.pop(name, None)
            else:
                v = int(version)
                mv = versions.get(v)
                if mv is None:
                    raise UnknownModelError(
                        f"unknown version {name}:v{version}")
                if self._active.get(name) == v and len(versions) > 1:
                    raise RegistryError(
                        f"{mv.key} is the active version; promote "
                        f"another version first")
                targets = [mv]
                del versions[v]
                if self._active.get(name) == v:
                    del self._active[name]
                can = self._canary.get(name)
                if can is not None and can.version == v:
                    del self._canary[name]
        removed = []
        for mv in targets:
            mv.drain(drain_timeout)
            if mv.model is not None:
                mv.model.release()
                mv.model = None
            mv.state = "retired"
            removed.append(mv.version)
        self._event(f"undeployed {name} versions {removed}")
        self._save()
        return removed

    def set_canary(self, name: str, version: int, weight: float,
                   error_threshold: Optional[float] = None,
                   min_requests: Optional[int] = None) -> CanaryState:
        """Split ``weight`` of ``name``'s default traffic onto
        ``version`` (which must exist; callers load cold versions via
        deploy/promote first)."""
        with self._lock:
            versions = self._models.get(name)
            mv = versions.get(int(version)) if versions else None
            if mv is None:
                raise UnknownModelError(
                    f"unknown version {name}:v{version}")
            can = CanaryState(
                version, weight,
                self.canary_error_threshold if error_threshold is None
                else error_threshold,
                self.canary_min_requests if min_requests is None
                else min_requests)
            self._canary[name] = can
        self._event(f"canary: {mv.key} at weight {can.weight}")
        self._save()
        return can

    def clear_canary(self, name: str):
        with self._lock:
            self._canary.pop(name, None)
        self._event(f"canary cleared for {name!r}")
        self._save()

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------
    @staticmethod
    def _canary_fraction(uri: str) -> float:
        """Deterministic uri -> [0, 1): the same record uri always lands
        on the same side of the split, across processes and restarts."""
        return (zlib.crc32(str(uri).encode("utf-8")) % 10_000) / 10_000.0

    def route(self, name: Optional[str] = None,
              version: Optional[int] = None, uri: str = "") -> ModelVersion:
        """Resolve a record to a loaded :class:`ModelVersion`: explicit
        ``version`` pins; otherwise the canary (when the uri hashes
        under its weight) or the active version."""
        name = name or self.default_model
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise UnknownModelError(f"unknown model {name!r}")
            if version is not None:
                mv = versions.get(int(version))
                if mv is None or mv.model is None:
                    raise UnknownModelError(
                        f"unknown or unloaded version {name}:v{version}")
                return mv
            can = self._canary.get(name)
            if can is not None and self._canary_fraction(uri) < can.weight:
                mv = versions.get(can.version)
                if mv is not None and mv.model is not None:
                    return mv
            active = self._active.get(name)
            mv = versions.get(active) if active is not None else None
            if mv is None or mv.model is None:
                raise UnknownModelError(
                    f"model {name!r} has no active loaded version")
            return mv

    def record_result(self, mv: ModelVersion, error: bool = False,
                      n: int = 1) -> bool:
        """Account ``n`` served (or failed) records against ``mv``; when
        ``mv`` is the canary and its error rate crosses the threshold,
        auto-roll the canary back.  Returns True iff a rollback fired."""
        can = None
        with self._lock:
            mv.requests += n
            if error:
                mv.errors += n
            c = self._canary.get(mv.name)
            if c is not None and c.version == mv.version:
                c.requests += n
                if error:
                    c.errors += n
                if (c.requests >= c.min_requests and
                        c.errors > c.error_threshold * c.requests):
                    del self._canary[mv.name]
                    mv.state = "failed"
                    can = c
        if can is not None:
            self._event(
                f"canary {mv.key} rolled back: error rate "
                f"{can.errors}/{can.requests} exceeds "
                f"{can.error_threshold:.2f}")
            self._save()
            return True
        return False

    def routed_versions(self) -> List[ModelVersion]:
        """Every loaded version traffic can currently reach (active +
        canary per model) — the warmup/bench surface."""
        out = []
        with self._lock:
            for name, versions in self._models.items():
                wanted = {self._active.get(name)}
                can = self._canary.get(name)
                if can is not None:
                    wanted.add(can.version)
                for v in wanted:
                    mv = versions.get(v) if v is not None else None
                    if mv is not None and mv.model is not None:
                        out.append(mv)
        return out

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def _save(self):
        uri = self.manifest_uri
        if uri is None:
            return
        with self._lock:
            data = {"default_model": self.default_model, "models": {}}
            for name, versions in self._models.items():
                can = self._canary.get(name)
                data["models"][name] = {
                    "active": self._active.get(name),
                    "canary": can.stats() if can is not None else None,
                    "versions": [
                        {"version": mv.version, "path": mv.path,
                         "state": mv.state, "created": mv.created,
                         "dtype": mv.dtype,
                         "calibration": mv.calibration}
                        for mv in sorted(versions.values(),
                                         key=lambda m: m.version)]}
        file_io.write_bytes_atomic(
            uri, json.dumps(data, indent=2).encode())

    def recover(self, load: bool = True,
                warmup: Optional[Callable] = None,
                save: bool = True) -> "ModelRegistry":
        """Rebuild the deployed set from the manifest.  With ``load``,
        the active (and canary) version of each model is re-loaded from
        its path and warmed; other versions stay ``cold`` (re-loadable
        via promote).  Load failures are logged and leave the version
        ``failed`` — the server still starts and dead-letters traffic
        for that model rather than crashing.

        Idempotent over loaded state: a version whose in-memory object
        already holds a loaded model is kept, not replaced with a cold
        shell — fleet workers call recover() on every manifest change
        (docs/serving-fleet.md) and must not drop live models mid-serve."""
        uri = self.manifest_uri
        if uri is None or not file_io.exists(uri):
            return self
        data = json.loads(file_io.read_bytes(uri).decode())
        with self._lock:
            self.default_model = data.get("default_model",
                                          self.default_model)
            for name, m in (data.get("models") or {}).items():
                versions = self._models.setdefault(name, {})
                for vd in m.get("versions", []):
                    v = int(vd["version"])
                    prior = versions.get(v)
                    if prior is not None and prior.model is not None:
                        continue   # already live in this process
                    mv = ModelVersion(name, v, path=vd.get("path"),
                                      dtype=vd.get("dtype", "f32"),
                                      calibration=vd.get("calibration"))
                    mv.created = vd.get("created", mv.created)
                    mv.state = "cold"
                    versions[v] = mv
                if m.get("active") is not None:
                    self._active[name] = int(m["active"])
                can = m.get("canary")
                if can:
                    self._canary[name] = CanaryState(
                        can["version"], can["weight"],
                        can.get("error_threshold",
                                self.canary_error_threshold),
                        can.get("min_requests", self.canary_min_requests))
        if load:
            for mv in self._cold_routed():
                try:
                    self._ensure_loaded(mv, warmup=warmup)
                    mv.state = "ready"
                    self._event(f"recovered {mv.key} from {mv.path}")
                except Exception as e:  # noqa: BLE001 - keep serving rest
                    logger.warning("recover: %s failed to load: %s",
                                   mv.key, e)
            if save:
                # follower workers refresh with save=False: only the
                # control-plane owner may rewrite the shared manifest
                self._save()
        return self

    def _cold_routed(self) -> List[ModelVersion]:
        out = []
        with self._lock:
            for name, versions in self._models.items():
                wanted = {self._active.get(name)}
                can = self._canary.get(name)
                if can is not None:
                    wanted.add(can.version)
                for v in wanted:
                    mv = versions.get(v) if v is not None else None
                    if mv is not None and mv.model is None and mv.path:
                        out.append(mv)
        return out

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Per-model/per-version control-plane + InferenceSummary stats
        (the ``models`` payload in ``pipeline_stats()`` and the
        ``zoo-serving status`` output)."""
        with self._lock:
            names = {name: (dict(versions), self._active.get(name),
                            self._canary.get(name))
                     for name, versions in self._models.items()}
            events = list(self.events)
        out = {}
        for name, (versions, active, can) in names.items():
            out[name] = {
                "active": active,
                "canary": can.stats() if can is not None else None,
                "versions": {v: mv.stats()
                             for v, mv in sorted(versions.items())}}
        return {"models": out, "events": events}


# ---------------------------------------------------------------------------
# file-RPC control plane (zoo-serving deploy/undeploy/promote/status)
# ---------------------------------------------------------------------------

def _control_dir(root: str) -> str:
    scheme, path = file_io.split_scheme(root)
    if scheme != "file":
        raise RegistryError(
            "the control plane is file-RPC on the serving host; "
            f"registry root {root!r} is not a local path")
    return os.path.join(path, "control")


def control_request(root: str, op: str, timeout: float = 180.0,
                    poll: float = 0.05, **kw) -> dict:
    """Send one control op to the serving process and wait for its
    response (exponential backoff up to 0.5s between polls)."""
    ctl = _control_dir(root)
    os.makedirs(ctl, exist_ok=True)
    rid = uuid.uuid4().hex[:12]
    req = os.path.join(ctl, f"{rid}.req.json")
    res = os.path.join(ctl, f"{rid}.res.json")
    tmp = req + ".tmp"
    with open(tmp, "w") as f:
        json.dump(dict(kw, op=op, id=rid), f)
    os.replace(tmp, req)  # atomic: the server never reads a partial file
    deadline = time.monotonic() + timeout
    interval = poll
    while time.monotonic() < deadline:
        if os.path.exists(res):
            with open(res) as f:
                data = json.load(f)
            os.unlink(res)
            return data
        time.sleep(interval)
        interval = min(interval * 2, 0.5)
    try:
        os.unlink(req)  # withdraw so a late server doesn't act on it
    except OSError:
        pass
    raise TimeoutError(
        f"no response to {op!r} within {timeout}s — is the serving "
        f"process running in registry mode?")


class RegistryControlServer:
    """Server half of the control plane: a daemon thread that applies
    ``deploy``/``undeploy``/``promote``/``canary``/``stats`` requests
    dropped into ``<root>/control`` and writes responses in place.
    Deploys run on this thread — warmup compiles never block the serve
    loop."""

    def __init__(self, registry: ModelRegistry, root: str, serving=None,
                 poll_interval: float = 0.2):
        self.registry = registry
        self.serving = serving  # RoutedClusterServing (warmup + stats)
        self.dir = _control_dir(root)
        os.makedirs(self.dir, exist_ok=True)
        self.poll_interval = poll_interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "RegistryControlServer":
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serving-registry-ctl")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 - control must survive
                logger.warning("control poll failed: %s", e)
            self._stop.wait(self.poll_interval)

    def poll_once(self) -> int:
        """Handle every pending request file; returns how many."""
        try:
            names = sorted(n for n in os.listdir(self.dir)
                           if n.endswith(".req.json"))
        except FileNotFoundError:
            return 0
        handled = 0
        for name in names:
            path = os.path.join(self.dir, name)
            try:
                with open(path) as f:
                    req = json.load(f)
                os.unlink(path)
            except (OSError, ValueError):
                continue
            resp = self._handle(req)
            res = os.path.join(self.dir,
                               name[:-len(".req.json")] + ".res.json")
            tmp = res + ".tmp"
            with open(tmp, "w") as f:
                json.dump(resp, f)
            os.replace(tmp, res)
            handled += 1
        return handled

    def _warmup_fn(self):
        if self.serving is not None:
            return self.serving.registry_warmup()
        return None

    def _handle(self, req: dict) -> dict:
        op = req.get("op")
        try:
            if op == "deploy":
                activate = bool(req.get("activate", True))
                weight = req.get("canary_weight")
                mv = self.registry.deploy(
                    req.get("model"), path=req["path"],
                    warmup=self._warmup_fn(),
                    activate=activate and weight is None,
                    quantize=bool(req.get("quantize", False)),
                    calibration=req.get("calibration"))
                if weight is not None:
                    self.registry.set_canary(mv.name, mv.version,
                                             float(weight))
                return {"ok": True, "model": mv.name,
                        "version": mv.version, "state": mv.state,
                        "dtype": mv.dtype}
            if op == "promote":
                mv = self.registry.promote(
                    req["model"], int(req["version"]),
                    warmup=self._warmup_fn())
                return {"ok": True, "model": mv.name,
                        "version": mv.version}
            if op == "undeploy":
                version = req.get("version")
                removed = self.registry.undeploy(
                    req["model"],
                    int(version) if version is not None else None)
                return {"ok": True, "model": req["model"],
                        "removed": removed}
            if op == "canary":
                mv_name = req["model"]
                with self.registry._lock:
                    versions = self.registry._models.get(mv_name) or {}
                    mv = versions.get(int(req["version"]))
                if mv is not None and mv.model is None:
                    self.registry._ensure_loaded(mv, self._warmup_fn())
                can = self.registry.set_canary(
                    mv_name, int(req["version"]), float(req["weight"]))
                return {"ok": True, "model": mv_name,
                        "canary": can.stats()}
            if op == "stats":
                if self.serving is not None:
                    return {"ok": True,
                            "stats": self.serving.pipeline_stats()}
                return {"ok": True, "stats": self.registry.stats()}
            return {"ok": False, "error": f"unknown op {op!r}"}
        except Exception as e:  # noqa: BLE001 - report, don't crash
            return {"ok": False, "error": str(e) or repr(e)}
