"""Service container: async dependency-injection / lifecycle kernel.

Reference parity: ``service-container/`` — named services with declared
dependencies and injectors (``ServiceBuilder.dependency/group/install``),
start ordering resolved from the dependency graph
(``ServiceDependencyResolver``), service groups with join/leave listeners
(how the reference broker reacts to leader partitions appearing:
``PartitionInstallService`` installs into LEADER_PARTITION_GROUP_NAME and
components subscribe), composite installs, and async stop cascading to
dependents. The whole broker is assembled from services
(``SystemContext.initSystemContext``).

Single-writer: the container itself is an Actor — all mutation runs on its
mailbox, so no locks around the registry.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Set

from zeebe_tpu_torch.runtime.actors import Actor, ActorFuture, ActorScheduler


class Service:
    """Optional base: services may be plain values; lifecycle hooks are
    duck-typed (``start(ctx)`` / ``stop(ctx)``)."""

    def start(self, ctx: "ServiceStartContext") -> None:  # noqa: B027
        pass

    def stop(self, ctx: "ServiceStopContext") -> None:  # noqa: B027
        pass


@dataclasses.dataclass
class ServiceStartContext:
    name: str
    container: "ServiceContainer"
    # injected dependency values by service name
    dependencies: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def get(self, dep_name: str) -> Any:
        return self.dependencies[dep_name]


@dataclasses.dataclass
class ServiceStopContext:
    name: str
    container: "ServiceContainer"


@dataclasses.dataclass
class _Registration:
    name: str
    service: Any
    dependencies: List[str]
    injectors: Dict[str, Callable[[Any], None]]
    groups: List[str]
    started: bool = False
    stopping: bool = False
    start_future: ActorFuture = dataclasses.field(default_factory=ActorFuture)
    stop_future: Optional[ActorFuture] = None


class ServiceBuilder:
    """Fluent install builder (reference ``ServiceBuilder``)."""

    def __init__(self, container: "ServiceContainer", name: str, service: Any):
        self._container = container
        self._name = name
        self._service = service
        self._dependencies: List[str] = []
        self._injectors: Dict[str, Callable[[Any], None]] = {}
        self._groups: List[str] = []

    def dependency(
        self, name: str, injector: Optional[Callable[[Any], None]] = None
    ) -> "ServiceBuilder":
        self._dependencies.append(name)
        if injector is not None:
            self._injectors[name] = injector
        return self

    def group(self, group_name: str) -> "ServiceBuilder":
        self._groups.append(group_name)
        return self

    def install(self) -> ActorFuture:
        reg = _Registration(
            name=self._name,
            service=self._service,
            dependencies=self._dependencies,
            injectors=self._injectors,
            groups=self._groups,
        )
        return self._container._install(reg)


class CompositeServiceBuilder:
    """Install a set of services atomically-ish: one future completing when
    all are started (reference ``CompositeServiceBuilder``)."""

    def __init__(self, container: "ServiceContainer"):
        self._container = container
        self._builders: List[ServiceBuilder] = []

    def create_service(self, name: str, service: Any) -> ServiceBuilder:
        b = self._container.create_service(name, service)
        self._builders.append(b)
        return b

    def install(self) -> ActorFuture:
        futures = [b.install() for b in self._builders]
        done = ActorFuture()
        remaining = [len(futures)]
        if not futures:
            done.complete([])
            return done

        def on_one(f: ActorFuture):
            if f._exception is not None:
                done.complete_exceptionally(f._exception)  # first failure wins
                return
            remaining[0] -= 1
            if remaining[0] == 0:
                done.complete([fut._value for fut in futures])

        for f in futures:
            f.on_complete(on_one)
        return done


class ServiceContainer(Actor):
    """The registry + dependency resolver."""

    def __init__(self, scheduler: ActorScheduler):
        super().__init__("service-container")
        self._scheduler = scheduler
        self._registry: Dict[str, _Registration] = {}
        self._group_members: Dict[str, Set[str]] = {}
        self._group_listeners: Dict[str, List] = {}
        scheduler.submit_actor(self)  # zblint: disable=unobserved-actor-future (boot submit; start failures land in the scheduler failure ring)

    # -- public API --------------------------------------------------------
    def create_service(self, name: str, service: Any) -> ServiceBuilder:
        return ServiceBuilder(self, name, service)

    def composite(self) -> CompositeServiceBuilder:
        return CompositeServiceBuilder(self)

    def get(self, name: str) -> Any:
        reg = self._registry.get(name)
        return reg.service if reg and reg.started else None

    def has_service(self, name: str) -> bool:
        reg = self._registry.get(name)
        return bool(reg and reg.started)

    def remove_service(self, name: str) -> ActorFuture:
        """Stop a service and, transitively, everything depending on it
        (reference: dependent services stop before their dependency)."""
        done = ActorFuture()
        self.actor.run(lambda: self._do_remove(name, done))
        return done

    def on_group_change(
        self,
        group_name: str,
        on_join: Optional[Callable[[str, Any], None]] = None,
        on_leave: Optional[Callable[[str, Any], None]] = None,
    ) -> None:
        """Group listeners (reference ServiceGroupReference): ``on_join``
        fires for existing members too."""

        def add():
            self._group_listeners.setdefault(group_name, []).append((on_join, on_leave))
            if on_join:
                for member in sorted(self._group_members.get(group_name, ())):
                    reg = self._registry.get(member)
                    if reg and reg.started:
                        on_join(member, reg.service)

        self.actor.run(add)

    def group_members(self, group_name: str) -> List[str]:
        return sorted(self._group_members.get(group_name, ()))

    # -- container-actor internals ----------------------------------------
    def _install(self, reg: _Registration) -> ActorFuture:
        def do_install():
            if reg.name in self._registry:
                reg.start_future.complete_exceptionally(
                    ValueError(f"service {reg.name!r} already installed")
                )
                return
            cycle = self._find_cycle(reg)
            if cycle is not None:
                reg.start_future.complete_exceptionally(
                    ValueError(
                        f"circular service dependency: {' -> '.join(cycle)}"
                    )
                )
                return
            self._registry[reg.name] = reg
            self._try_start_ready()

        self.actor.run(do_install)
        return reg.start_future

    def _find_cycle(self, new_reg: _Registration):
        """Detect a dependency cycle that installing ``new_reg`` would close
        (reference ServiceDependencyResolver rejects circular dependencies
        instead of hanging the install)."""
        graph = {name: r.dependencies for name, r in self._registry.items()}
        graph[new_reg.name] = new_reg.dependencies
        path: List[str] = []
        on_path = set()
        visited = set()

        def visit(name: str):
            if name in on_path:
                return path[path.index(name):] + [name]
            if name in visited or name not in graph:
                return None
            visited.add(name)
            on_path.add(name)
            path.append(name)
            for dep in graph[name]:
                found = visit(dep)
                if found:
                    return found
            path.pop()
            on_path.discard(name)
            return None

        return visit(new_reg.name)

    def _try_start_ready(self) -> None:
        progressed = True
        while progressed:
            progressed = False
            for reg in list(self._registry.values()):
                if reg.started or reg.stopping:
                    continue
                deps = [self._registry.get(d) for d in reg.dependencies]
                if all(d is not None and d.started for d in deps):
                    self._start_one(reg)
                    progressed = True

    def _start_one(self, reg: _Registration) -> None:
        ctx = ServiceStartContext(
            name=reg.name,
            container=self,
            dependencies={d: self._registry[d].service for d in reg.dependencies},
        )
        for dep_name, injector in reg.injectors.items():
            injector(self._registry[dep_name].service)
        start = getattr(reg.service, "start", None)
        if callable(start):
            try:
                start(ctx)
            except Exception as e:  # noqa: BLE001
                reg.start_future.complete_exceptionally(e)
                del self._registry[reg.name]
                return
        reg.started = True
        for group in reg.groups:
            self._group_members.setdefault(group, set()).add(reg.name)
            for on_join, _ in self._group_listeners.get(group, ()):
                if on_join:
                    on_join(reg.name, reg.service)
        reg.start_future.complete(reg.service)

    def _dependents_of(self, name: str) -> List[str]:
        return [
            r.name
            for r in self._registry.values()
            if name in r.dependencies and r.started and not r.stopping
        ]

    def _do_remove(self, name: str, done: ActorFuture) -> None:
        reg = self._registry.get(name)
        if reg is None:
            done.complete()
            return
        if reg.stopping:
            # an in-flight removal owns the stop: park this caller on it
            reg.stop_future.on_complete(lambda _f: done.complete())
            return
        if not reg.started:
            # never started: no stop() to run; unblock anyone awaiting install
            self._registry.pop(name, None)
            reg.start_future.complete_exceptionally(
                ValueError(f"service {name!r} removed before start")
            )
            done.complete()
            return
        reg.stopping = True
        reg.stop_future = done
        dependents = self._dependents_of(name)
        remaining = [len(dependents)]

        def stop_self():
            for group in reg.groups:
                members = self._group_members.get(group, set())
                members.discard(reg.name)
                for _, on_leave in self._group_listeners.get(group, ()):
                    if on_leave:
                        on_leave(reg.name, reg.service)
            stop = getattr(reg.service, "stop", None)
            if callable(stop):
                try:
                    stop(ServiceStopContext(name=reg.name, container=self))
                except Exception:  # noqa: BLE001
                    import traceback

                    traceback.print_exc()
            self._registry.pop(reg.name, None)
            done.complete()

        if not dependents:
            stop_self()
            return

        def on_dependent_stopped(_f):
            remaining[0] -= 1
            if remaining[0] == 0:
                self.actor.run(stop_self)

        for dep in dependents:
            child_done = ActorFuture()
            self._do_remove(dep, child_done)
            child_done.on_complete(on_dependent_stopped)

    def close(self) -> ActorFuture:
        """Stop every service, leaves-first (reference
        ServiceContainer.closeAsync)."""
        done = ActorFuture()

        def do_close():
            roots = [
                r.name
                for r in self._registry.values()
                if r.started and not r.stopping
            ]
            remaining = [len(roots)]
            if not remaining[0]:
                done.complete()
                return

            def on_one(_f):
                remaining[0] -= 1
                if remaining[0] == 0:
                    done.complete()

            for name in roots:
                child = ActorFuture()
                self._do_remove(name, child)
                child.on_complete(on_one)

        self.actor.run(do_close)
        return done
