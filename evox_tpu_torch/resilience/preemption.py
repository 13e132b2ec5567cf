"""Signal-aware graceful shutdown for supervised runs (counterpart of
``evox_tpu/resilience/preemption.py``, a copy: stdlib only).

``SIGTERM`` is how real schedulers kill jobs: Kubernetes pod eviction,
SLURM time limits, and spot/preemptible reclamation all send it with a
grace window (typically 30 s) before the ``SIGKILL`` that nothing survives.
Python's default handler turns ``SIGTERM`` into instant process death —
which, for a supervised run, loses every generation since the last segment
boundary and can land *mid-write* if a checkpoint was in flight.

:class:`PreemptionGuard` converts the signal into a cooperative flag.  The
:class:`~evox_tpu_torch.resilience.ResilientRunner` checks the flag at
every segment boundary; when it trips, the runner barriers any in-flight
async checkpoint write, publishes an **emergency checkpoint** whose
manifest records ``preempted`` (and bumps the monitor's
``num_preemptions`` counter in the saved state), restores the prior signal
handlers, and raises :class:`Preempted` — so the process exits cleanly
inside the grace window and the *next* invocation of the same two lines
auto-resumes bit-identically from the boundary the signal interrupted.

Cloud maintenance events that arrive out-of-band (a metadata server, a
preemption notice file) plug in through ``provider_hook`` — a
zero-argument callable polled at the same boundaries; returning a truthy
value trips the guard exactly like a signal.  ``trip()`` trips it manually
(tests, custom integrations).

A guard is deliberately *two-strike*: the first signal is absorbed into
the flag (graceful path), but a second signal while the flag is already
set restores the original handlers and re-raises itself — repeated
``SIGTERM``/``Ctrl-C`` must always be able to kill a process that wedged
during its graceful shutdown.
"""

from __future__ import annotations

import signal
import threading
import warnings
from typing import Callable, Iterable, Union

__all__ = ["PreemptionGuard", "Preempted"]


class Preempted(RuntimeError):
    """The run was stopped cooperatively by a :class:`PreemptionGuard`.

    This is control flow, not a failure: when it reaches you, the emergency
    checkpoint is already durably on disk and re-running the same
    supervisor resumes bit-identically.  A top-level driver should catch it
    and exit 0 (or re-queue the job) — the scheduler's next incarnation of
    the process picks the run back up.

    :ivar generation: completed generations at the boundary that tripped.
    :ivar reason: what tripped the guard (e.g. ``"signal SIGTERM"``).
    :ivar checkpoint: path of the emergency checkpoint (``None`` only if
        the emergency write itself failed — the previous boundary
        checkpoint then remains the resume point).
    """

    def __init__(
        self,
        message: str,
        *,
        generation: int | None = None,
        reason: str | None = None,
        checkpoint=None,
    ):
        super().__init__(message)
        self.generation = generation
        self.reason = reason
        self.checkpoint = checkpoint


class PreemptionGuard:
    """Turns ``SIGTERM``/``SIGINT`` (and provider maintenance events) into
    a flag the run supervisor polls at segment boundaries.

    Usage — explicit, around anything::

        guard = PreemptionGuard()
        with guard:                       # install handlers, restore on exit
            runner = ResilientRunner(wf, "ckpts/run", preemption=guard)
            try:
                runner.run(state, n_steps=10_000)
            except Preempted:
                sys.exit(0)               # checkpoint is on disk; requeue

    or implicit — ``ResilientRunner(preemption=True)`` builds and installs
    a default guard for the duration of each :meth:`run`.

    Thread/signal semantics: the flag is a :class:`threading.Event`, so
    tripping is safe from signal handlers, provider-poll results, and
    other threads alike.  Handler installation must happen on the main
    thread (a CPython restriction); polling can happen anywhere.

    :param signals: signal numbers to intercept (default
        ``(SIGTERM, SIGINT)``).
    :param provider_hook: optional zero-argument callable polled by
        :attr:`triggered`; return a truthy value (a string becomes the
        recorded reason) when the platform announced maintenance /
        preemption.  A hook that *raises* is disabled after a warning —
        a broken poller must not veto every future segment boundary.
    """

    def __init__(
        self,
        *,
        signals: Iterable[Union[int, signal.Signals]] = (
            signal.SIGTERM,
            signal.SIGINT,
        ),
        provider_hook: Callable[[], object] | None = None,
    ):
        self.signals = tuple(signals)
        self.provider_hook = provider_hook
        self._event = threading.Event()
        self._reason: str | None = None
        self._prev: dict = {}
        self._installed = False

    # -- handler lifecycle -------------------------------------------------
    @property
    def installed(self) -> bool:
        """Whether this guard's handlers are currently installed."""
        return self._installed

    def install(self) -> "PreemptionGuard":
        """Install the signal handlers, remembering the previous ones.
        Idempotent; returns ``self``.  Main thread only (CPython)."""
        if self._installed:
            return self
        for sig in self.signals:
            self._prev[sig] = signal.signal(sig, self._handler)
        self._installed = True
        return self

    def uninstall(self) -> None:
        """Restore the signal handlers that were active before
        :meth:`install`.  Idempotent."""
        if not self._installed:
            return
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
            except (ValueError, OSError, TypeError):  # pragma: no cover
                pass  # interpreter teardown / non-main thread
        self._prev.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def _handler(self, signum, frame) -> None:
        del frame
        if self._event.is_set():
            # Second strike: the graceful path already had its chance.
            # Give the signal its default (usually fatal) meaning back so
            # an operator hammering Ctrl-C, or a scheduler escalating, can
            # always kill a wedged shutdown.
            self.uninstall()
            signal.raise_signal(signum)
            return
        try:
            name = signal.Signals(signum).name
        except ValueError:  # pragma: no cover - exotic signal number
            name = str(signum)
        self.trip(f"signal {name}")

    # -- tripping ----------------------------------------------------------
    def trip(self, reason: str = "manual") -> None:
        """Set the flag (signal handler, provider callback, or test)."""
        if self._reason is None:
            self._reason = str(reason)
        self._event.set()

    def reset(self) -> None:
        """Clear the flag and reason (a new run through the same guard).

        ``ResilientRunner(preemption=True)`` resets its own guard at every
        ``run()``; a caller-owned guard (``preemption=guard``) must be
        reset by the caller before reusing it for another run — otherwise
        the stale flag trips the new run at its first boundary."""
        self._event.clear()
        self._reason = None

    @property
    def reason(self) -> str | None:
        """What tripped the guard, or ``None``."""
        return self._reason

    @property
    def triggered(self) -> bool:
        """Whether the run should stop at the next boundary.  Polls
        ``provider_hook`` (when set) in addition to the signal flag."""
        if self._event.is_set():
            return True
        if self.provider_hook is not None:
            try:
                notice = self.provider_hook()
            except Exception as e:  # noqa: BLE001 - see docstring
                warnings.warn(
                    f"preemption provider_hook raised {e!r}; disabling the "
                    f"hook (signals still guarded)"
                )
                self.provider_hook = None
                return False
            if notice:
                self.trip(
                    notice
                    if isinstance(notice, str)
                    else "provider maintenance event"
                )
                return True
        return False
