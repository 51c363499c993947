"""Cross-tenant batched Phase-3 solves: stacked sweeps and the micro-batcher.

Every tenant's Phase-3 solve runs off an already-cached factor, and T
tenants sharing a dimension differ only in data, so a server can answer
requests that arrive together in one sweep:

  * :func:`solve_stacked` — one sweep over T snapshotted ``(L, G, h,
    sigma)`` operands (``DenseBackend.solve_operands``), run with no tenant
    lock held. Each lane runs the same ``backends._factor_solve`` that
    ``DenseBackend.solve`` and ``solve_snapshot`` run (the float32 solve
    refined once with a float64 residual), so a lane is bit-identical to
    the tenant's lone solve at the same state, on the card as on the CPU.
    A batched ``torch.cholesky_solve`` over ``[T, d, d]`` may take another
    cuSOLVER/cuBLAS kernel and give other bits, so it is not used.
  * :class:`SolveBatcher` — the micro-batching window in front of
    ``EnginePool.solve_many``. Requests landing within ``window_s`` of each
    other coalesce into one stacked sweep; a lone request on an idle server
    dispatches at once.

The reference pads the batch extent to a power of two to bound its
compiled programs; eager PyTorch has nothing to retrace, so the port does
not pad.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Sequence

import torch

from repro_torch.server.backends import _factor_solve


def solve_stacked(entries: Sequence[tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor, float]]
                  ) -> list[torch.Tensor]:
    """Solve every snapshotted ``(L, G, h, sigma)`` quadruple in one sweep.

    All entries must share (d, dtype, device): the caller buckets.
    """
    if not entries:
        return []
    L0 = entries[0][0]
    for L, *_ in entries:
        if (L.shape[-1], L.dtype, L.device) != (L0.shape[-1], L0.dtype, L0.device):
            raise ValueError(
                f"solve_stacked needs one (d, dtype, device) bucket, got "
                f"{(L0.shape[-1], L0.dtype, L0.device)} and "
                f"{(L.shape[-1], L.dtype, L.device)}")
    return [_factor_solve(L, G, h, float(sigma)) for L, G, h, sigma in entries]


@dataclasses.dataclass
class _Pending:
    tenant: str
    sigma: float
    future: Future


_STOP = object()


class SolveBatcher:
    """Micro-batching window in front of ``EnginePool.solve_many``.

    Group-commit scheduling with an adaptive window: a request is held back
    (for up to ``window_s``, collecting companions) only when it arrived
    within ``window_s`` of the end of the last sweep, i.e. while traffic is
    streaming. A request hitting an idle batcher dispatches at once, after
    sweeping up whatever already queued.

    ``submit`` returns a ``concurrent.futures.Future``; ``solve`` blocks on
    it. When a sweep raises, each of its requests is re-run alone and its
    own future gets its own result or exception, so one bad tenant name
    fails only its request; a kernel error still reaches every caller it
    hits. ``summary()["fallbacks"]`` (the reference's name) counts those
    isolated sweeps.
    """

    def __init__(self, pool, *, window_s: float = 0.002,
                 max_batch: int = 256, lifted: bool = True):
        self.pool = pool
        self.window_s = window_s
        self.max_batch = max_batch
        self.lifted = lifted
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._thread: threading.Thread | None = None
        self._last_sweep_end = -float("inf")
        self.sweeps = 0
        self.requests = 0
        self.lone_dispatches = 0
        self.max_batch_seen = 0
        self.fallbacks = 0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "SolveBatcher":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name=f"SolveBatcher-{id(self):x}",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        if self._thread is None:
            return
        self._q.put(_STOP)
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():   # pragma: no cover - join timed out
            raise RuntimeError("SolveBatcher thread failed to stop")
        self._thread = None

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def __enter__(self) -> "SolveBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- submission ----------------------------------------------------------

    def submit(self, tenant: str, sigma: float) -> Future:
        """Enqueue one solve; the Future resolves to the (lifted) weights."""
        if not self.alive:
            raise RuntimeError("SolveBatcher is not running; call start()")
        f: Future = Future()
        self._q.put(_Pending(tenant, float(sigma), f))
        return f

    def solve(self, tenant: str, sigma: float) -> torch.Tensor:
        return self.submit(tenant, sigma).result()

    def summary(self) -> dict:
        return {
            "window_s": self.window_s,
            "sweeps": self.sweeps,
            "requests": self.requests,
            "lone_dispatches": self.lone_dispatches,
            "max_batch_seen": self.max_batch_seen,
            "fallbacks": self.fallbacks,
        }

    # -- scheduler loop ------------------------------------------------------

    def _collect(self, first: _Pending) -> tuple[list[_Pending], bool]:
        """Gather the batch for one sweep; returns (batch, saw stop)."""
        batch = [first]
        arrived = time.monotonic()
        streaming = arrived - self._last_sweep_end <= self.window_s
        deadline = arrived + self.window_s
        while len(batch) < self.max_batch:
            try:
                if streaming:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    nxt = self._q.get(timeout=remaining)
                else:
                    nxt = self._q.get_nowait()
            except queue.Empty:
                break
            if nxt is _STOP:
                return batch, True
            batch.append(nxt)
        return batch, False

    def _run(self) -> None:
        while True:
            first = self._q.get()
            if first is _STOP:
                return
            batch, stopping = self._collect(first)
            self._dispatch(batch)
            self._last_sweep_end = time.monotonic()
            if stopping:
                return

    def _dispatch(self, batch: list[_Pending]) -> None:
        self.sweeps += 1
        self.requests += len(batch)
        self.max_batch_seen = max(self.max_batch_seen, len(batch))
        if len(batch) == 1:
            self.lone_dispatches += 1
        try:
            ws = self.pool.solve_many([(p.tenant, p.sigma) for p in batch],
                                      lifted=self.lifted)
        except Exception:
            # Isolate the failure: each request alone, its own outcome.
            self.fallbacks += 1
            for p in batch:
                try:
                    w = (self.pool.solve_lifted(p.tenant, p.sigma)
                         if self.lifted else self.pool.solve(p.tenant, p.sigma))
                except Exception as e:
                    p.future.set_exception(e)
                else:
                    p.future.set_result(w)
            return
        for p, w in zip(batch, ws):
            p.future.set_result(w)
