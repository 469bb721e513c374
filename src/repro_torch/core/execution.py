"""ExecutionBackend: the single model-execution interface under serving
(port of ``repro/core/execution.py``).

``resolve_estimator``, ``BatchExecution``, ``ExecutionBackend``,
``ReplayBackend``, ``TokenReplayBackend`` and ``profile_backend`` are
verbatim copies of the reference (the numpy layer both executors share).
``EngineBackend`` is the port: it drives ``InferenceEngine``-like objects
whose ``infer`` returns torch tensors. On the card one ``argmax_gap``
launch (the top2gap kernel) reduces a batch's (n, C) scores to its
certainties and predictions, and both reach the host in one transfer.
``CostModelBackend`` (the analytic roofline) is a verbatim copy too; the
cost model it reads runs on the H100's constants.

Both executors (the discrete-event ``ServingSimulator`` and the threaded
``CascadeServer``) obtain per-sample (pred, certainty, correctness) and
per-batch runtimes only through one of these backends, and
``profile_backend`` is the one entry point that turns any backend into the
``ModelProfile`` artifacts the gear planner consumes:

* ``ReplayBackend`` — validation-record replay + profile-interpolated
  runtimes (the simulator's physics; with ``sleep=True``, compute-free
  wall-clock stress runs of the threaded server).
* ``EngineBackend`` — real models through ``InferenceEngine`` (the
  server's physics; with a token pool the simulator can drive it in
  virtual time).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import (Callable, Dict, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.convert import tensor_leaves
from repro_torch.core.certainty import top2_gap
from repro_torch.core.profiles import (ModelProfile, ProfileSet, TokenProfile,
                                 TokenProfileSet, ValidationRecord)
from repro_torch.kernels.top2gap import argmax_gap

__all__ = ["BatchExecution", "ExecutionBackend", "ReplayBackend",
           "EngineBackend", "CostModelBackend", "TokenReplayBackend",
           "profile_backend", "resolve_estimator"]


def resolve_estimator(est: Union[str, Callable]) -> Callable:
    """Resolve a certainty estimator name to its callable (passing callables
    through). The ONLY place ``CERTAINTY_ESTIMATORS`` is consulted — the
    estimator choice of a serving stack lives in its backend, nowhere else.
    """
    if callable(est):
        return est
    from repro_torch.core.certainty import CERTAINTY_ESTIMATORS
    try:
        return CERTAINTY_ESTIMATORS[est]
    except KeyError:
        raise ValueError(
            f"unknown certainty estimator {est!r}; available: "
            f"{sorted(CERTAINTY_ESTIMATORS)}") from None


@dataclass
class BatchExecution:
    """What executing one batch produced, per sample (aligned with the
    submitted sample order).

    ``certs`` always present — every cascade decision needs it. ``preds``
    and ``correct`` are present when the backend can know them (an engine
    without labels knows predictions but not correctness; a replay backend
    without recorded preds knows correctness but not the label). ``elapsed``
    is the wall seconds the execution physically took (None for virtual
    backends, whose service time is ``batch_runtime``).
    """
    certs: Sequence[float]
    preds: Optional[Sequence[int]] = None
    correct: Optional[Sequence[bool]] = None
    elapsed: Optional[float] = None


class ExecutionBackend:
    """Protocol: everything an executor may ask about model execution.

    Drivers (simulator, server) own state and time; ``SchedulerCore`` owns
    decisions; backends own *physics* — what a batch costs and what each
    sample's prediction/certainty is.
    """

    name: str = "backend"

    def models(self) -> List[str]:
        raise NotImplementedError

    def batch_runtime(self, model: str, batch_size: int) -> float:
        """Predicted seconds for one batch (virtual-time service time)."""
        raise NotImplementedError

    def execute(self, model: str, sids: Sequence[int],
                tokens: Optional[Sequence[np.ndarray]] = None
                ) -> BatchExecution:
        """Run one batch of samples ``sids`` (payloads in ``tokens`` when
        the caller has them) and return per-sample outcomes."""
        raise NotImplementedError

    def validation_record(self, model: str) -> ValidationRecord:
        raise NotImplementedError

    def profile(self, model: str,
                batch_sizes: Optional[Sequence[int]] = None,
                **kw) -> ModelProfile:
        """The ModelProfile artifact the gear planner consumes for
        ``model`` — use ``profile_backend`` rather than calling directly."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# ReplayBackend: validation-record replay (simulator physics)
# ---------------------------------------------------------------------------

class ReplayBackend(ExecutionBackend):
    """Replays recorded per-sample validation behaviour with profile-
    interpolated batch runtimes — the paper's App. C simulator physics.

    Sample ``sid`` replays validation index ``sid % n_val`` (validation
    sets must align across the family, as in ``evaluate_cascade``). With
    ``sleep=True`` every ``execute`` blocks for the profiled batch runtime,
    so the *threaded wall-clock* server can serve this backend at QPS far
    beyond what real model compute allows (scheduler/queue stress runs).
    """

    name = "replay"

    # list-comp gather beats a numpy fancy-index + tolist() round-trip for
    # small batches; past this size the vectorized path wins
    _BATCH_GATHER_MIN = 32

    def __init__(self, profiles: ProfileSet, sleep: bool = False):
        if not profiles:
            raise ValueError("ReplayBackend needs at least one profile")
        self.profiles = profiles
        self.sleep = sleep
        self._val_n = len(next(iter(profiles.values())).validation.certs)
        # scalar lists, not arrays: the simulator's completion path does
        # per-sample scalar reads, where list indexing beats numpy boxing
        self._certs = {m: p.validation.certs.tolist()
                       for m, p in profiles.items()}
        self._corr = {m: p.validation.correct.tolist()
                      for m, p in profiles.items()}
        self._preds = {m: (p.validation.preds.tolist()
                           if p.validation.preds is not None else None)
                       for m, p in profiles.items()}
        # numpy views of the same records for batched (large-batch) gathers
        self._certs_np = {m: p.validation.certs for m, p in profiles.items()}
        self._corr_np = {m: p.validation.correct
                         for m, p in profiles.items()}
        self._preds_np = {m: p.validation.preds
                          for m, p in profiles.items()}
        # per-(model, batch) runtime memo: the interpolation is pure, and
        # the planner + DES hot paths ask for the same few batch sizes
        # millions of times
        self._rt_memo: Dict[Tuple[str, int], float] = {}

    @property
    def validation_n(self) -> int:
        return self._val_n

    def models(self) -> List[str]:
        return list(self.profiles)

    def batch_runtime(self, model: str, batch_size: int) -> float:
        rt = self._rt_memo.get((model, batch_size))
        if rt is None:
            rt = self.profiles[model].runtime(batch_size)
            self._rt_memo[(model, batch_size)] = rt
        return rt

    def execute(self, model: str, sids: Sequence[int],
                tokens: Optional[Sequence[np.ndarray]] = None
                ) -> BatchExecution:
        n = self._val_n
        elapsed = None
        if self.sleep:
            elapsed = self.batch_runtime(model, len(sids))
            time.sleep(elapsed)
        if len(sids) >= self._BATCH_GATHER_MIN:
            # batched cert/correctness lookups: one fancy-index gather per
            # batch (same values as the scalar path, elementwise)
            vi = np.asarray(sids, np.int64) % n
            preds_np = self._preds_np[model]
            return BatchExecution(
                certs=self._certs_np[model][vi].tolist(),
                preds=preds_np[vi].tolist() if preds_np is not None
                else None,
                correct=self._corr_np[model][vi].tolist(),
                elapsed=elapsed)
        certs, corr, preds = \
            self._certs[model], self._corr[model], self._preds[model]
        vi = [s % n for s in sids]
        return BatchExecution(
            certs=[certs[i] for i in vi],
            preds=[preds[i] for i in vi] if preds is not None else None,
            correct=[corr[i] for i in vi],
            elapsed=elapsed)

    def validation_record(self, model: str) -> ValidationRecord:
        return self.profiles[model].validation

    def profile(self, model: str,
                batch_sizes: Optional[Sequence[int]] = None,
                **kw) -> ModelProfile:
        """The stored profile IS the artifact (optionally re-sampled onto a
        different batch-size grid via the same interpolation the runtime
        model uses)."""
        p = self.profiles[model]
        if batch_sizes is None:
            return p
        bs = np.asarray(batch_sizes, np.float64)
        return ModelProfile(
            name=p.name, mem_bytes=p.mem_bytes, batch_sizes=bs,
            batch_runtimes=np.asarray([p.runtime(b) for b in bs]),
            devices_per_replica=p.devices_per_replica,
            validation=p.validation)


# ---------------------------------------------------------------------------
# TokenReplayBackend: per-token replay physics (token-level DES)
# ---------------------------------------------------------------------------

class TokenReplayBackend:
    """Token-level replay physics for the virtual-time token DES
    (DESIGN.md §13) — the generation analogue of ``ReplayBackend``.

    One request ``sid`` at model ``m`` replays validation index
    ``sid % n_val`` of ``m``'s ``TokenProfile``: its generation length, its
    per-token certainty-gap stream (fed to the SAME ``StreamingCertainty``
    fold the real ``TokenEngine`` uses), and its correctness if resolved at
    ``m``. Costs are the profile's prompt-proportional prefill and
    batch-dependent per-step decode runtimes. Everything is deterministic
    in ``sid``, so continuous-batching runs are reproducible and comparable
    across scheduling modes on the same trace.
    """

    name = "token_replay"

    def __init__(self, token_profiles: TokenProfileSet):
        if not token_profiles:
            raise ValueError("TokenReplayBackend needs at least one profile")
        self.token_profiles = dict(token_profiles)
        self._rt_memo: Dict[Tuple[str, int], float] = {}
        # scalar-read views (the DES step loop reads one gap at a time)
        self._gen = {m: p.gen_len.tolist()
                     for m, p in token_profiles.items()}
        self._gaps = {m: p.gaps for m, p in token_profiles.items()}
        self._corr = {m: p.correct.tolist()
                      for m, p in token_profiles.items()}
        self._n = {m: p.validation_n for m, p in token_profiles.items()}

    def models(self) -> List[str]:
        return list(self.token_profiles)

    def prefill_runtime(self, model: str, prompt_tokens: int) -> float:
        return self.token_profiles[model].prefill_runtime(prompt_tokens)

    def decode_step_runtime(self, model: str, batch: int) -> float:
        rt = self._rt_memo.get((model, batch))
        if rt is None:
            rt = self.token_profiles[model].decode_step_runtime(batch)
            self._rt_memo[(model, batch)] = rt
        return rt

    def gen_len(self, model: str, sid: int) -> int:
        return self._gen[model][sid % self._n[model]]

    def token_gap(self, model: str, sid: int, pos: int) -> float:
        """Certainty gap of the ``pos``-th generated token (0-based)."""
        return float(self._gaps[model][sid % self._n[model], pos])

    def correct(self, model: str, sid: int) -> bool:
        return self._corr[model][sid % self._n[model]]

    def kv_bytes_per_slot(self, model: str) -> float:
        return self.token_profiles[model].kv_bytes_per_slot

    @classmethod
    def from_gap_streams(cls, models: Sequence[str],
                         stage_gaps: Sequence[Mapping[int, Sequence[float]]],
                         gen_len: Sequence[int],
                         correct: Optional[Mapping[str, Sequence[bool]]]
                         = None,
                         prefill_per_token: float = 1e-4,
                         decode_step_runtime: float = 1e-3,
                         kv_bytes_per_slot: float = 1.0
                         ) -> "TokenReplayBackend":
        """Backend that replays gap streams RECORDED by a real engine run
        (``TokenResult.stage_gaps``) — the bridge for engine-vs-DES
        decision-parity tests (DESIGN.md §14).

        ``stage_gaps[sid]`` maps stage index -> the per-token gaps request
        ``sid`` actually consumed at that stage; ``gen_len[sid]`` is its
        generation budget (``max_new``). Rows for (model, sid) pairs the
        request never visited are zero-filled — under a parity replay the
        DES makes the same decisions from the same folds, so it never
        reads them; a mid-stream-escalated stage's stream is zero-padded
        past the escalation point for the same reason. Runtimes are
        uniform placeholders (parity tests compare DECISIONS, not time).
        """
        n = len(stage_gaps)
        if n == 0 or len(gen_len) != n:
            raise ValueError(
                f"stage_gaps/gen_len must align and be non-empty "
                f"({n} vs {len(gen_len)})")
        gen = np.asarray(gen_len, np.int64)
        width = max(1, int(gen.max()))
        profiles: TokenProfileSet = {}
        for si, name in enumerate(models):
            gaps = np.zeros((n, width), np.float64)
            for sid, per_stage in enumerate(stage_gaps):
                row = np.asarray(per_stage.get(si, ()), np.float64)
                gaps[sid, :row.size] = row[:width]
            corr = np.asarray(correct[name], bool) if correct is not None \
                else np.ones(n, bool)
            profiles[name] = TokenProfile(
                name=name, prefill_per_token=prefill_per_token,
                decode_batch_sizes=np.asarray([1.0]),
                decode_step_runtimes=np.asarray([decode_step_runtime]),
                kv_bytes_per_slot=kv_bytes_per_slot,
                gen_len=gen, gaps=gaps, correct=corr)
        return cls(profiles)


# ---------------------------------------------------------------------------
# EngineBackend: real models in PyTorch (server physics)
# ---------------------------------------------------------------------------

def _reduce_tensor(scores: torch.Tensor, estimator: Callable
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(certs float64, preds int64) on the host for a batch of (n, C)
    scores that lie in a tensor. With the ``top2_gap`` estimator one
    ``argmax_gap`` launch gives both (the top2gap kernel on the card, its
    plain version on the CPU); any other estimator runs as torch ops beside
    a torch argmax. Certainties (f32, carried as their bits) and
    predictions (i32) reach the host in ONE copy."""
    if estimator is top2_gap:
        preds, certs = argmax_gap(scores.float().contiguous())
    else:
        certs = estimator(scores).float()
        preds = torch.argmax(scores, dim=-1).to(torch.int32)
    both = torch.stack([certs.view(torch.int32), preds]).cpu().numpy()
    return (both[0].view(np.float32).astype(np.float64),
            both[1].astype(np.int64))


class EngineBackend(ExecutionBackend):
    """Real execution through ``InferenceEngine``-like objects (anything
    with ``infer(tokens) -> scores``), certainty via the shared estimator
    registry.

    Scores in a torch tensor (the port's engines) are reduced where they
    lie: on the card, certainties and predictions come from one launch of
    the top2gap kernel (``top2_gap`` estimator) or from torch ops (the
    others), and reach the host in one copy; ``elapsed`` ends after that
    copy. Scores in a numpy array (host data) are reduced on the host as
    the reference does.

    ``tokens``/``labels`` are optional sid-indexed pools: with a token pool
    the backend can execute from sample ids alone (so the discrete-event
    simulator can drive REAL models in virtual time); with labels it also
    reports per-sample correctness. ``profiles`` (when provided) back
    ``batch_runtime`` for virtual-time drivers.
    """

    name = "engine"

    def __init__(self, engines: Mapping[str, object],
                 estimator: Union[str, Callable] = "top2_gap",
                 profiles: Optional[ProfileSet] = None,
                 tokens: Optional[np.ndarray] = None,
                 labels: Optional[np.ndarray] = None):
        self.engines = dict(engines)
        self.estimator = resolve_estimator(estimator)
        self.profiles = profiles
        self._tokens = None if tokens is None else np.asarray(tokens)
        self._labels = None if labels is None else np.asarray(labels)

    def models(self) -> List[str]:
        return list(self.engines)

    def batch_runtime(self, model: str, batch_size: int) -> float:
        if self.profiles is None or model not in self.profiles:
            raise RuntimeError(
                f"EngineBackend has no profile for {model!r}; attach "
                "profiles (e.g. via profile_backend) before virtual-time "
                "use")
        return self.profiles[model].runtime(batch_size)

    def execute(self, model: str, sids: Sequence[int],
                tokens: Optional[Sequence[np.ndarray]] = None
                ) -> BatchExecution:
        if tokens is None:
            if self._tokens is None:
                raise RuntimeError(
                    "EngineBackend.execute needs per-sample tokens (or a "
                    "token pool at construction)")
            pool_n = len(self._tokens)
            batch = self._tokens[[s % pool_n for s in sids]]
        else:
            batch = np.stack([np.asarray(t) for t in tokens])
        t0 = time.perf_counter()
        scores = self.engines[model].infer(batch)
        if isinstance(scores, torch.Tensor):
            certs, preds = _reduce_tensor(scores, self.estimator)
            elapsed = time.perf_counter() - t0
        else:
            elapsed = time.perf_counter() - t0
            certs = np.asarray(self.estimator(scores), np.float64)
            preds = scores.argmax(-1)
        correct = None
        if tokens is None and self._labels is not None:
            # correctness is only knowable when the inputs came from the
            # sid-indexed pool the labels belong to — caller-supplied
            # tokens would pair real predictions with unrelated labels
            lab_n = len(self._labels)
            correct = (preds == self._labels[[s % lab_n for s in sids]]
                       ).tolist()
        return BatchExecution(certs=certs, preds=preds, correct=correct,
                              elapsed=elapsed)

    def validation_record(self, model: str) -> ValidationRecord:
        if self.profiles is None or model not in self.profiles:
            raise RuntimeError(f"no validation record attached for {model!r}")
        return self.profiles[model].validation

    def profile(self, model: str,
                batch_sizes: Optional[Sequence[int]] = None,
                seq_len: int = 32, repeats: int = 5,
                mem_bytes: Optional[float] = None,
                validation: Optional[ValidationRecord] = None,
                **kw) -> ModelProfile:
        """Measure wall-clock batch runtimes (median of ``repeats``) through
        the engine's own bucketed path, so the planner sees the padding cost
        (DESIGN.md §3.2); ``infer`` returns only once its scores exist on
        the device. ``mem_bytes`` defaults to 4 B per parameter element, as
        the reference counts it. This is the one measurement
        implementation; ``repro_torch.serving.engine.profile_engine``
        delegates here."""
        if batch_sizes is None:
            batch_sizes = (1, 2, 4, 8, 16, 32, 64)
        batch_sizes = tuple(int(b) for b in batch_sizes)
        engine = self.engines[model]
        warmup = getattr(engine, "warmup", None)
        if warmup is not None:
            warmup(seq_len)
        rts = []
        for b in batch_sizes:
            tok = np.zeros((b, seq_len), np.int32)
            times = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                engine.infer(tok)
                times.append(time.perf_counter() - t0)
            rts.append(float(np.median(times)))
        if mem_bytes is None:
            params = getattr(engine, "params", None)
            mem_bytes = sum(float(t.numel()) * 4
                            for t in tensor_leaves(params))
        if validation is None and self.profiles and model in self.profiles:
            validation = self.profiles[model].validation
        return ModelProfile(
            name=model, mem_bytes=float(mem_bytes),
            batch_sizes=np.asarray(batch_sizes, np.float64),
            batch_runtimes=np.asarray(rts),
            validation=validation or ValidationRecord(
                certs=np.zeros(1), correct=np.ones(1, bool)))


# ---------------------------------------------------------------------------
# CostModelBackend: the analytic roofline, here on the H100's constants
# (``repro_torch/profiling/hw.py``)
# ---------------------------------------------------------------------------

class CostModelBackend(ReplayBackend):
    """The assigned big architectures cannot run on this container, so their
    physics come from the analytic TPU-v5e roofline
    (``repro.profiling.cost_model.analytic_runtime``) with synthetic or
    measured validation behaviour replayed per sample — a ReplayBackend
    whose profiles are derived, not measured.

    ``archs`` maps model name -> ModelConfig (or an arch id resolvable via
    ``repro.configs.get_config``); ``validation`` maps model name ->
    ValidationRecord (certainty structure cannot be derived analytically).
    """

    name = "cost_model"

    def __init__(self, archs: Mapping[str, object],
                 validation: Optional[Mapping[str, ValidationRecord]] = None,
                 context: int = 2048, kind: str = "decode",
                 chips: Optional[Mapping[str, int]] = None,
                 batch_sizes: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128)):
        from repro_torch.configs import get_config
        from repro_torch.profiling.cost_model import profile_from_cost_model
        profiles: ProfileSet = {}
        for name, cfg in archs.items():
            if isinstance(cfg, str):
                cfg = get_config(cfg)
            profiles[name] = profile_from_cost_model(
                cfg, context=context, kind=kind,
                chips=(chips or {}).get(name),
                batch_sizes=batch_sizes,
                validation=(validation or {}).get(name))
            profiles[name].name = name
        super().__init__(profiles)
        self.context = context
        self.kind = kind


# ---------------------------------------------------------------------------
# Unified profile production
# ---------------------------------------------------------------------------

def profile_backend(backend: ExecutionBackend,
                    model: Optional[str] = None,
                    batch_sizes: Optional[Sequence[int]] = None,
                    **kw) -> Union[ModelProfile, ProfileSet]:
    """THE entry point for ModelProfile production (paper App. C.1).

    One model name returns its ``ModelProfile``; with ``model=None`` every
    model the backend serves is profiled into a ``ProfileSet``. The planner
    consumes identical artifacts whether the source is a wall-clock engine
    measurement, the analytic roofline, or an existing profile — and the
    profile is produced by the same backend object the executor will run,
    so planner inputs cannot drift from served physics.
    """
    if model is not None:
        return backend.profile(model, batch_sizes=batch_sizes, **kw)
    return {m: backend.profile(m, batch_sizes=batch_sizes, **kw)
            for m in backend.models()}
