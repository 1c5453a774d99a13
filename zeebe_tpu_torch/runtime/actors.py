"""Actor scheduler: the runtime's concurrency model.

Reference parity: ``util/src/main/java/io/zeebe/util/sched/`` — green-thread
cooperative scheduling (``ActorScheduler.java:34``), actors as single-writer
state machines whose jobs never run concurrently, the ``ActorControl`` API
(run / submit / run_delayed / run_at_fixed_rate / on_condition / futures,
``ActorControl.java:62-478``), a CPU-bound work-stealing thread group + an
IO-bound group (``WorkStealingGroup.java:22``), a pluggable clock
(``clock/ActorClock.java``) and a controlled scheduler for deterministic
tests (``testing/ControlledActorSchedulerRule``).

TPU-native re-design, not a port: the hot path of this framework is the
batched device kernel, so the scheduler's job is the *control plane* —
periodic snapshotting, timer/TTL sweeps, metrics flush, transport polling,
raft heartbeats. Python threads suffice for that (the GIL is irrelevant to
control-plane rates); the single-writer actor contract is what matters and
is preserved: an actor's jobs are serialized through its own mailbox, so
actor state needs no locks.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, List, Optional


class ActorFuture:
    """Completion future usable from actor callbacks.

    Reference: ``util/.../sched/future/CompletableActorFuture.java``.
    """

    def __init__(self):
        self._event = threading.Event()
        self._value: Any = None
        self._exception: Optional[BaseException] = None
        self._callbacks: List[Callable[["ActorFuture"], None]] = []
        self._lock = threading.Lock()

    def complete(self, value: Any = None) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._value = value
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            cb(self)

    def complete_exceptionally(self, exc: BaseException) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._exception = exc
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            cb(self)

    def is_done(self) -> bool:
        return self._event.is_set()

    def join(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("future not completed in time")
        if self._exception is not None:
            raise self._exception
        return self._value

    def on_complete(self, callback: Callable[["ActorFuture"], None]) -> None:
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(callback)
                return
        callback(self)


class _Timer:
    __slots__ = ("deadline", "seq", "job", "interval", "cancelled")

    def __init__(self, deadline: float, seq: int, job: "_Job", interval: Optional[float]):
        self.deadline = deadline
        self.seq = seq
        self.job = job
        self.interval = interval
        self.cancelled = False

    def __lt__(self, other):
        return (self.deadline, self.seq) < (other.deadline, other.seq)

    def cancel(self) -> None:
        self.cancelled = True


class _Job:
    __slots__ = ("actor", "fn")

    def __init__(self, actor: "Actor", fn: Callable[[], None]):
        self.actor = actor
        self.fn = fn


class _Condition:
    """Reference: ``ActorControl.onCondition`` — a named wakeup that
    schedules its job each time it is signalled."""

    __slots__ = ("name", "job", "scheduler")

    def __init__(self, name: str, job: _Job, scheduler: "ActorScheduler"):
        self.name = name
        self.job = job
        self.scheduler = scheduler

    def signal(self) -> None:
        self.scheduler._enqueue(self.job)


class ActorControl:
    """The API an actor uses to schedule its own work (single-writer:
    everything lands in this actor's serialized mailbox)."""

    def __init__(self, actor: "Actor", scheduler: "ActorScheduler"):
        self._actor = actor
        self._scheduler = scheduler

    def run(self, fn: Callable[[], None]) -> None:
        """Enqueue a job on this actor (reference actor.run/submit)."""
        self._scheduler._enqueue(_Job(self._actor, fn))

    submit = run

    def run_delayed(self, delay_ms: int, fn: Callable[[], None]) -> _Timer:
        return self._scheduler._schedule_timer(
            self._actor, delay_ms, fn, interval_ms=None
        )

    def run_at_fixed_rate(self, period_ms: int, fn: Callable[[], None]) -> _Timer:
        return self._scheduler._schedule_timer(
            self._actor, period_ms, fn, interval_ms=period_ms
        )

    def on_condition(self, name: str, fn: Callable[[], None]) -> _Condition:
        return _Condition(name, _Job(self._actor, fn), self._scheduler)

    def call(self, fn: Callable[[], Any]) -> ActorFuture:
        """Run ``fn`` on this actor; complete a future with its result
        (reference ActorControl.call — the cross-actor ask pattern)."""
        future = ActorFuture()

        def run():
            try:
                future.complete(fn())
            except BaseException as e:  # noqa: BLE001 - forwarded to future
                future.complete_exceptionally(e)

        self.run(run)
        return future

    def run_on_completion(self, future: ActorFuture, fn: Callable[[ActorFuture], None]) -> None:
        """Resume on this actor when ``future`` completes (the actor-safe
        continuation; reference actor.runOnCompletion)."""
        future.on_complete(lambda f: self.run(lambda: fn(f)))


class Actor:
    """Base class: subclass and override ``on_actor_started`` /
    ``on_actor_closing``. All callbacks run serialized (single-writer)."""

    def __init__(self, name: Optional[str] = None):
        self.name = name or type(self).__name__
        self.actor: ActorControl = None  # injected at submit
        self._mailbox: deque = deque()
        self._running = False  # a worker is draining this actor's mailbox
        self._closed = False
        self._failure_count = 0  # jobs that raised (see ActorScheduler._drain)
        self._mailbox_lock = threading.Lock()

    def on_actor_started(self) -> None:  # noqa: B027 - optional hook
        pass

    def on_actor_closing(self) -> None:  # noqa: B027 - optional hook
        pass


class ActorScheduler:
    """Thread-group scheduler: ``cpu_threads`` workers drain actor mailboxes
    from a shared run queue (work sharing — contention profile of Python
    makes stealing pointless), ``io_threads`` drain io-submitted actors, and
    one timer thread expires delays/fixed-rates.

    Reference: ``ActorScheduler.newActorScheduler().build(); start()``
    (SystemContext.java:128-144 uses 2 cpu + 2 io by default).
    """

    def __init__(self, cpu_threads: int = 2, io_threads: int = 2, clock=None):
        self._clock = clock  # None → wall clock; callable → millis
        self._runq: deque = deque()
        self._io_runq: deque = deque()
        self._cv = threading.Condition()
        self._timers: List[_Timer] = []
        self._timer_seq = itertools.count()
        self._threads: List[threading.Thread] = []
        self._cpu_threads = cpu_threads
        self._io_threads = io_threads
        self._started = False
        self._stopping = False
        # failure escalation (reference ActorTask.java:38-48 — actor job
        # failures are counted and surfaced, never silently swallowed):
        # total count + a bounded ring of (actor_name, traceback) pairs,
        # plus listeners (broker health wires in here). Round-4 lesson: a
        # bare print turned a NameError in the broker tick into two
        # silent zero-perf rounds.
        self.actor_failures = 0
        self.last_failures: deque = deque(maxlen=32)
        self._failure_lock = threading.Lock()
        self._failure_listeners: List[Callable[[Actor, BaseException], None]] = []

    def on_actor_failure(
        self, listener: Callable[[Actor, BaseException], None]
    ) -> None:
        """Register a listener called (from the failing worker thread) on
        every actor-job exception."""
        self._failure_listeners.append(listener)

    def remove_actor_failure_listener(
        self, listener: Callable[[Actor, BaseException], None]
    ) -> None:
        try:
            self._failure_listeners.remove(listener)
        except ValueError:
            pass

    def _record_failure(self, actor: Actor, exc: BaseException) -> None:
        """Escalate one actor-job exception: traceback to stderr, counters
        + bounded failure ring (thread-safe — worker threads race here),
        then listener fan-out (a listener must never kill the worker)."""
        import traceback

        traceback.print_exc()
        with self._failure_lock:
            self.actor_failures += 1
            actor._failure_count += 1
            self.last_failures.append((actor.name, traceback.format_exc()))
        for listener in list(self._failure_listeners):
            try:
                listener(actor, exc)
            except Exception:  # noqa: BLE001
                traceback.print_exc()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ActorScheduler":
        if self._started:
            return self
        self._started = True
        for i in range(self._cpu_threads):
            t = threading.Thread(
                target=self._worker, args=(self._runq,), name=f"zb-actor-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)
        for i in range(self._io_threads):
            t = threading.Thread(
                target=self._worker, args=(self._io_runq,), name=f"zb-io-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._timer_loop, name="zb-timer", daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def stop(self, timeout: float = 5.0) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout)
        self._threads.clear()

    # -- actor submission --------------------------------------------------
    def submit_actor(self, actor: Actor, io_bound: bool = False) -> ActorFuture:
        """Install an actor; resolves when on_actor_started ran.

        Reference: ActorScheduler.submitActor (+ io-bound group selection).
        """
        actor.actor = ActorControl(actor, self)
        actor._io_bound = io_bound
        started = ActorFuture()

        def boot():
            actor.on_actor_started()
            started.complete(actor)

        self._enqueue(_Job(actor, boot))
        return started

    def close_actor(self, actor: Actor) -> ActorFuture:
        done = ActorFuture()

        def close():
            actor.on_actor_closing()
            actor._closed = True
            done.complete()

        self._enqueue(_Job(actor, close))
        return done

    # -- internals ---------------------------------------------------------
    def now_ms(self) -> int:
        if self._clock is not None:
            return self._clock()
        return int(time.monotonic() * 1000)

    def _enqueue(self, job: _Job) -> None:
        actor = job.actor
        with actor._mailbox_lock:
            if actor._closed:
                return
            actor._mailbox.append(job.fn)
            if actor._running:
                return  # the draining worker will pick it up
            actor._running = True
        queue = self._io_runq if getattr(actor, "_io_bound", False) else self._runq
        with self._cv:
            queue.append(actor)
            self._cv.notify()

    def _schedule_timer(
        self, actor: Actor, delay_ms: int, fn: Callable[[], None], interval_ms
    ) -> _Timer:
        timer = _Timer(
            self.now_ms() + delay_ms, next(self._timer_seq), _Job(actor, fn), interval_ms
        )
        with self._cv:
            heapq.heappush(self._timers, timer)
            self._cv.notify_all()
        return timer

    def _worker(self, queue: deque) -> None:
        while True:
            with self._cv:
                while not queue and not self._stopping:
                    self._cv.wait(0.1)
                if self._stopping:
                    return
                actor = queue.popleft()
            self._drain(actor)

    def _drain(self, actor: Actor, max_jobs: int = 64) -> None:
        """Run up to max_jobs queued jobs of one actor, then yield the thread
        (cooperative fairness — the reference's task-switching)."""
        for _ in range(max_jobs):
            with actor._mailbox_lock:
                if not actor._mailbox:
                    actor._running = False
                    return
                fn = actor._mailbox.popleft()
            try:
                fn()
            except Exception as exc:  # noqa: BLE001
                self._record_failure(actor, exc)
        # still work left: requeue for fairness
        queue = self._io_runq if getattr(actor, "_io_bound", False) else self._runq
        with self._cv:
            queue.append(actor)
            self._cv.notify()

    def _expire_due_timers(self, now: int) -> None:
        """Pop cancelled/due timers, enqueue their jobs, reschedule fixed
        rates. Caller holds no lock in the controlled scheduler; the
        threaded timer loop calls under self._cv."""
        while self._timers and (
            self._timers[0].cancelled or self._timers[0].deadline <= now
        ):
            timer = heapq.heappop(self._timers)
            if timer.cancelled:
                continue
            self._enqueue(timer.job)
            if timer.interval is not None:
                timer.deadline = now + timer.interval
                heapq.heappush(self._timers, timer)

    def _timer_loop(self) -> None:
        while True:
            with self._cv:
                if self._stopping:
                    return
                now = self.now_ms()
                self._expire_due_timers(now)
                # sleep until the next deadline (or a new timer / stop wakes
                # us); under a controlled clock poll at a coarse interval
                if self._clock is not None:
                    wait_s = 0.001
                elif self._timers:
                    wait_s = max((self._timers[0].deadline - now) / 1000.0, 0.0)
                else:
                    wait_s = 0.5
                self._cv.wait(wait_s)


class ControlledActorScheduler(ActorScheduler):
    """Deterministic scheduler for tests: no threads; work runs only when
    ``work_until_done()`` is called, and time advances only via the supplied
    controlled clock.

    Reference: ``util/.../sched/testing/ControlledActorSchedulerRule`` +
    ``ControlledActorClock`` (SURVEY.md §4 determinism tooling).
    """

    def __init__(self, clock=None):
        super().__init__(cpu_threads=0, io_threads=0, clock=clock)

    def start(self) -> "ControlledActorScheduler":
        self._started = True
        return self

    def work_until_done(self, max_jobs: int = 100_000) -> int:
        """Expire due timers and drain all mailboxes; returns jobs run. Job
        exceptions are reported (like the threaded drain) but never wedge
        the actor."""
        ran = 0
        while True:
            self._expire_due_timers(self.now_ms())
            actor = None
            for q in (self._runq, self._io_runq):
                if q:
                    actor = q.popleft()
                    break
            if actor is None:
                return ran
            while True:
                with actor._mailbox_lock:
                    if not actor._mailbox:
                        actor._running = False
                        break
                    fn = actor._mailbox.popleft()
                try:
                    fn()
                except Exception as exc:  # noqa: BLE001
                    self._record_failure(actor, exc)
                ran += 1
                if ran > max_jobs:
                    raise RuntimeError("controlled scheduler did not quiesce")
