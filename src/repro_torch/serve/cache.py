"""Artifact LRU for the serving runtime.

A server fronting many models cannot afford a balanced-DP solve per
request; it also cannot pin every (model, target, options) artifact
forever.  :class:`ArtifactCache` is the standard answer: an LRU of
:class:`~repro_torch.api.artifact.CompiledArtifact`\\ s keyed by the model
name plus :meth:`CompileOptions.cache_key()
<repro_torch.core.compile_driver.CompileOptions.cache_key>` — the same
stable digest the ``REPRO_BENCH_CACHE`` disk cache uses — so two
option bundles that compile identically share an entry and two that
differ never collide.
"""
from __future__ import annotations

import collections
import threading
from typing import Optional

from repro_torch import instrument
from repro_torch.core.compile_driver import CompileOptions


class ArtifactCache:
    """Bounded LRU of compiled artifacts, keyed
    ``(name, options.cache_key())``.

    ``get_or_compile(name, make, options)`` returns the cached artifact
    or compiles one via :func:`repro_torch.api.artifact.compile_graph` on
    ``make()`` (any graph/builder the front door accepts).  Thread-safe;
    hits/misses/evictions accumulate in :attr:`stats` and are mirrored
    to the ambient tracer as an ``artifact_cache`` counter series.
    """

    def __init__(self, capacity: int = 8) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._items: "collections.OrderedDict[tuple, object]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.stats = {"hits": 0, "misses": 0, "evictions": 0}

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def key_for(self, name: str, options: Optional[CompileOptions]) -> tuple:
        options = options or CompileOptions()
        return (name, options.cache_key())

    def get(self, name: str, options: Optional[CompileOptions] = None):
        """The cached artifact, or ``None`` — counts as hit/miss."""
        key = self.key_for(name, options)
        with self._lock:
            art = self._items.get(key)
            if art is not None:
                self._items.move_to_end(key)
                self.stats["hits"] += 1
            else:
                self.stats["misses"] += 1
            self._emit_locked()
            return art

    def put(self, name: str, options: Optional[CompileOptions],
            artifact) -> None:
        key = self.key_for(name, options)
        with self._lock:
            if key in self._items:
                self._items.move_to_end(key)
                self._items[key] = artifact
            else:
                while len(self._items) >= self.capacity:  # LRU eviction
                    self._items.popitem(last=False)
                    self.stats["evictions"] += 1
                self._items[key] = artifact
            self._emit_locked()

    def get_or_compile(self, name: str, make,
                       options: Optional[CompileOptions] = None):
        """Cached artifact for ``(name, options)``, compiling (and
        inserting) on miss.  The compile runs outside the lock — two
        racing misses may both compile, last insert wins (artifacts are
        deterministic, so either result is correct)."""
        from repro_torch.api.artifact import compile_graph

        art = self.get(name, options)
        if art is not None:
            return art
        graph = make() if callable(make) else make
        art = compile_graph(graph, options=options or CompileOptions())
        self.put(name, options, art)
        return art

    def _emit_locked(self) -> None:
        tracer = instrument.current()
        if tracer.enabled:
            tracer.counter("artifact_cache", dict(self.stats))
