"""Persistent program cache — restarts that build no kernel (counterpart of
``evox_tpu/utils/exec_cache.py``).

The JAX package persists a compiled XLA executable and loads it in a later
process instead of compiling.  A captured CUDA graph cannot be serialized:
it holds the addresses of the process that captured it.  What a restarted
process of the port pays before its first segment is the ``nvcc`` build of
every kernel library it launches (seconds each), then the capture of each
program (a warm-up generation and the capture itself).  So
:class:`ExecutableCache` keeps the contract of the JAX package's cache —
the same files, keys, integrity checks, quarantine and statistics — over
what the port can persist: a program's **capture record**
(:class:`CaptureRecord`): the bytes of every kernel library the process
had loaded when it captured the program (the program's, and those that
built its inputs), each with its own SHA-256, as ``ops/_build.py`` built
them.  The record holds no tensor on the card, and no sink site: a
process captures every program it runs, hit or miss, and the capture
records its own.

A live cache supplies the libraries its entries hold to every build of
this process (``ops._build.add_library_source``): before ``nvcc`` would
build a missing library, the cache finds it in a verified entry of this
environment, and ``_build.install`` places it atomically after checking
its SHA-256.  So a process whose programs are hits runs no ``nvcc``, even
for a kernel it launches before its first lookup (a tenant's setup
draws); the capture itself still runs, once a program.

**Nothing loaded is trusted.**  Every entry is a self-describing file —
magic, header JSON (format, key material, payload SHA-256, the libraries
it carries), payload — and the load path verifies all of it: a
truncated/bit-flipped/unpicklable entry, *or* an entry whose recorded
environment no longer matches (another torch or CUDA version, another
card, another world size, edited kernel sources), is **quarantined** to
``*.corrupt`` (never deleted, never silently reused) and reported as a
miss, so the caller captures anew.  Every *mutating* file operation —
temp staging, payload write, publish, quarantine rename — routes through
the :class:`~evox_tpu_torch.utils.CheckpointStore` seam (``FaultyStore``
chaos applies), and saves are atomic (temp + ``fsync`` + ``os.replace``).

:func:`enable_xla_compilation_cache` keeps the JAX package's name for its
counterpart in a torch process: the bytecode of the modules a process
imports, cached under one shared directory.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import pickle
import struct
import sys
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Union

import torch
from torch.utils import _pytree as pytree

from .checkpoint import CheckpointStore, quarantine_target

__all__ = [
    "CaptureRecord",
    "ExecutableCache",
    "ExecCacheStats",
    "abstract_signature",
    "capture_record",
    "compile_uncached",
    "enable_xla_compilation_cache",
]

_MAGIC = b"EVOXEXEC"
_FORMAT = 1
# Header struct: magic (8s) + header-JSON byte length (<I).
_HEADER = struct.Struct("<8sI")
# An entry's file name: exe_<32 hex digits of its key digest> + this suffix.
SUFFIX = ".evoxexe"


def abstract_signature(*args: Any) -> tuple:
    """Hashable abstract identity of a call's inputs: every leaf's key
    path plus its ``(shape, dtype)``, over torch's pytree.  Two calls with
    equal signatures run the same program (given the same callable), so
    the signature — not the values — keys the cache.  Key paths are
    deterministic across processes."""
    leaves, _ = pytree.tree_flatten_with_path(args)
    return tuple(
        (
            pytree.keystr(path),
            tuple(getattr(leaf, "shape", ()) or ()),
            str(getattr(leaf, "dtype", type(leaf).__name__)),
        )
        for path, leaf in leaves
    )


@functools.cache
def _kernel_libraries() -> dict[str, str]:
    from ..ops import _build

    return _build.library_names()


def _environment_fingerprint() -> dict[str, Any]:
    """What must match for a capture record to be installable AND
    correct: the torch and CUDA runtime versions, the card (name, count,
    compute capability), the world size, and the name ``ops/_build.py``
    gives each kernel library (a hash of its source, every header and the
    flags).  A mismatch is the "stale / wrong topology" case — the entry
    is quarantined, never trusted."""
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        card = {
            "device": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(),
            "capability": f"{major}.{minor}",
        }
    else:
        card = {"device": "cpu", "device_count": 0, "capability": None}
    dist = torch.distributed
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        **card,
        "world_size": world,
        "kernels": _kernel_libraries(),
    }


@dataclass
class CaptureRecord:
    """What a later process needs before it captures a program: the kernel
    libraries, ``{file name: (sha256, bytes)}``."""

    libraries: dict[str, tuple[str, bytes]] = field(default_factory=dict)


def capture_record() -> CaptureRecord:
    """The record of a program captured just now: the bytes of every
    kernel library this process has loaded, with their SHA-256."""
    from ..ops import _build

    libraries = {}
    for path in _build.loaded().values():
        data = Path(path).read_bytes()
        libraries[Path(path).name] = (hashlib.sha256(data).hexdigest(), data)
    return CaptureRecord(libraries=libraries)


class ExecCacheStats:
    """Counters of what the cache did (mirrored into the metrics registry
    when one is attached)."""

    def __init__(self) -> None:
        self.hits = 0
        self.misses = 0
        self.saves = 0
        self.save_failures = 0
        self.quarantines = 0
        # (path, reason) per quarantined entry — evidence, like
        # ``RunStats.checkpoint_skips``.
        self.quarantined: list[tuple[Path, str]] = []

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"ExecCacheStats(hits={self.hits}, misses={self.misses}, "
            f"saves={self.saves}, save_failures={self.save_failures}, "
            f"quarantines={self.quarantines})"
        )


class ExecutableCache:
    """Digest-guarded persistent store of programs' capture records.

    Usage (what :class:`~evox_tpu_torch.service.TenantPack` and
    :class:`~evox_tpu_torch.resilience.ResilientRunner` do internally)::

        cache = ExecutableCache("svc_root/exec_cache")  # supplies libraries
        sig = abstract_signature(carry)
        hit = cache.load("segment[16]", sig) is not None
        graph.prepare(...)                       # the capture: always
        if not hit:
            cache.save("segment[16]", sig, capture_record())

    :param directory: cache directory (created on first save).
    :param store: the :class:`~evox_tpu_torch.utils.CheckpointStore` every
        mutating file operation routes through (``FaultyStore``
        chaos-injectable).
    :param durable: fsync entries on publish (default True — the cache
        exists to survive the process).
    :param on_event: optional one-line event callback (quarantines, save
        failures); defaults to ``warnings.warn`` for quarantines.
    :param registry: optional duck-typed
        :class:`~evox_tpu_torch.obs.MetricsRegistry`; feeds
        ``evox_exec_cache_{hits,misses,saves,save_failures,quarantines}_total``.
    """

    def __init__(
        self,
        directory: Union[str, Path],
        *,
        store: CheckpointStore | None = None,
        durable: bool = True,
        on_event: Callable[[str], None] | None = None,
        registry: Any | None = None,
    ):
        from ..ops import _build

        self.directory = Path(directory)
        self.store = store if store is not None else CheckpointStore()
        self.durable = bool(durable)
        self.on_event = on_event
        self.registry = registry
        self.stats = ExecCacheStats()
        _build.add_library_source(self.library)

    # -- events / metrics ---------------------------------------------------
    def _event(self, msg: str, *, warn: bool = False) -> None:
        if self.on_event is not None:
            self.on_event(msg)
        elif warn:
            warnings.warn(msg)

    def _inc(self, name: str, help: str) -> None:
        if self.registry is None:
            return
        try:
            self.registry.counter(name, help).inc()
        except Exception:  # pragma: no cover - broken registry
            pass

    def _miss(self) -> None:
        self.stats.misses += 1
        self._inc("evox_exec_cache_misses_total", "Executable-cache lookups that had to capture.")

    # -- keying -------------------------------------------------------------
    def _key_material(self, label: str, signature: Any) -> dict[str, Any]:
        material = dict(_environment_fingerprint())
        material["label"] = str(label)
        material["signature"] = hashlib.sha256(repr(signature).encode()).hexdigest()
        material["evox_tpu_torch_version"] = _library_version()
        return material

    def entry_path(self, label: str, signature: Any) -> Path:
        """Deterministic file path of the entry for ``(label, signature)``
        in the current environment."""
        material = self._key_material(label, signature)
        digest = hashlib.sha256(json.dumps(material, sort_keys=True).encode()).hexdigest()
        return self.directory / f"exe_{digest[:32]}{SUFFIX}"

    # -- quarantine ---------------------------------------------------------
    def _quarantine(self, path: Path, reason: str) -> None:
        self.stats.quarantines += 1
        self.stats.quarantined.append((path, reason))
        self._inc("evox_exec_cache_quarantines_total", "Executable-cache entries quarantined as *.corrupt.")
        renamed = ""
        try:
            self.store.rename(path, quarantine_target(path))
            renamed = " (quarantined)"
        except OSError:  # racing cleaners / read-only store
            pass
        self._event(f"exec cache rejected {path.name}: {reason}{renamed}; capturing anew", warn=True)

    # -- load ---------------------------------------------------------------
    def load(self, label: str, signature: Any) -> Any | None:
        """The unpickled program for ``(label, signature)``, or ``None``
        (miss).  Corrupt, stale, or wrong-topology entries are quarantined
        ``*.corrupt`` and reported as misses — a cache entry is never
        trusted past its digests."""
        path = self.entry_path(label, signature)
        try:
            blob = path.read_bytes()
        except FileNotFoundError:
            self._miss()
            return None
        except OSError as e:
            self._miss()
            self._event(f"exec cache could not read {path.name} ({e}); capturing anew", warn=True)
            return None
        header, payload, reason = _parse(blob)
        if reason is None:
            reason = self._stale(header, self._key_material(label, signature))
        program = None
        if reason is None:
            try:
                program = pickle.loads(payload)
            except Exception as e:  # noqa: BLE001 - any load failure -> capture anew
                reason = f"deserialization failed ({type(e).__name__}: {e})"
        if reason is not None:
            self._quarantine(path, reason)
            self._miss()
            return None
        self.stats.hits += 1
        self._inc("evox_exec_cache_hits_total", "Executable-cache lookups served without a build.")
        return program

    @staticmethod
    def _stale(header: dict, expected: dict) -> str | None:
        # Digest-clean: now gate on key material.  The file name already
        # encodes the digest of the CURRENT environment's material, so a
        # stale entry is normally unreachable — but a renamed/copied file
        # must still be refused by content, not by file name.
        recorded = header.get("key", {})
        if recorded == expected:
            return None
        diff = sorted(k for k in set(expected) | set(recorded) if expected.get(k) != recorded.get(k))
        return (
            f"stale entry: key material differs on {diff} (e.g. captured with another torch or CUDA "
            f"version, card, world size or kernel source)"
        )

    def library(self, file_name: str) -> tuple[bytes, str] | None:
        """``(bytes, sha256)`` of the kernel library ``file_name`` from an
        entry of this environment that carries it, or ``None``.  Entries
        are read-only here: a damaged one is passed over (its program's
        load quarantines it)."""
        if not self.directory.is_dir():
            return None
        env = _environment_fingerprint()
        for path in sorted(self.directory.glob(f"exe_*{SUFFIX}")):
            try:
                header, payload, reason = _parse(path.read_bytes())
            except OSError:
                continue
            if reason is not None or file_name not in header.get("libraries", {}):
                continue
            key = header.get("key", {})
            if any(key.get(k) != v for k, v in env.items()):
                continue
            try:
                sha, data = pickle.loads(payload).libraries[file_name]
            except Exception:  # noqa: BLE001 - not a capture record after all
                continue
            return data, sha
        return None

    # -- save ---------------------------------------------------------------
    def save(self, label: str, signature: Any, program: Any) -> Path | None:
        """Pickle and atomically publish one program (a capture record).
        Failures (an unpicklable program, ``ENOSPC``, a torn store) are
        events, not aborts — the caller already holds the live program and
        a later restart simply captures anew.  Returns the published path
        or ``None``."""
        try:
            payload = pickle.dumps(program)
            # Trust nothing, including our own serialization: prove the
            # payload round-trips BEFORE publishing it.
            pickle.loads(payload)
        except Exception as e:  # noqa: BLE001 - not picklable
            self.stats.save_failures += 1
            self._event(
                f"exec cache could not serialize {label!r} ({type(e).__name__}: {e}); restarts will capture anew",
                warn=True,
            )
            return None
        libraries = getattr(program, "libraries", None) or {}
        header = {
            "format": _FORMAT,
            "key": self._key_material(label, signature),
            "payload_sha256": hashlib.sha256(payload).hexdigest(),
            "libraries": {name: sha for name, (sha, _) in sorted(libraries.items())},
            "created_at": time.time(),
        }
        header_json = json.dumps(header, sort_keys=True).encode()
        blob = _HEADER.pack(_MAGIC, len(header_json)) + header_json + payload
        path = self.entry_path(label, signature)
        try:
            self.directory.mkdir(parents=True, exist_ok=True)
            fd, tmp = self.store.open_temp(self.directory, path.name + ".tmp.")
            try:
                with os.fdopen(fd, "wb") as f:
                    self.store.write_bytes(f, blob)
                    if self.durable:
                        self.store.fsync_file(f)
                self.store.publish(tmp, path)
                if self.durable:
                    self.store.fsync_dir(self.directory)
            except BaseException:
                try:
                    self.store.unlink(tmp)
                except OSError:
                    pass
                raise
        except (OSError, RuntimeError) as e:
            self.stats.save_failures += 1
            self._inc("evox_exec_cache_save_failures_total", "Executable-cache publishes that failed.")
            self._event(
                f"exec cache write of {path.name} failed ({type(e).__name__}: {e}); restarts will capture anew",
                warn=True,
            )
            return None
        self.stats.saves += 1
        self._inc("evox_exec_cache_saves_total", "Programs durably published to the cache.")
        return path

    def get_or_compile(self, label: str, signature: Any, compile_fn: Callable[[], Any]) -> tuple[Any, bool]:
        """One-stop lookup: returns ``(program, was_cached)``.  On a miss,
        ``compile_fn()`` makes the program (a capture and its record) and
        the result is saved for the next process."""
        program = self.load(label, signature)
        if program is not None:
            return program, True
        program = compile_fn()
        self.save(label, signature, program)
        return program, False


def _parse(blob: bytes) -> tuple[dict, bytes, str | None]:
    """``(header, payload, reason)`` of an entry's bytes; ``reason`` names
    what is wrong with them (``None`` when magic, header and payload
    digest check out)."""
    if len(blob) < _HEADER.size:
        return {}, b"", "truncated header"
    magic, header_len = _HEADER.unpack_from(blob)
    if magic != _MAGIC:
        return {}, b"", "bad magic — not an exec-cache entry"
    header_end = _HEADER.size + header_len
    if len(blob) < header_end:
        return {}, b"", "truncated header JSON"
    try:
        header = json.loads(blob[_HEADER.size : header_end])
    except (UnicodeDecodeError, json.JSONDecodeError):
        return {}, b"", "unparseable header JSON"
    if not isinstance(header, dict) or header.get("format") != _FORMAT:
        return {}, b"", f"unknown entry format {header.get('format') if isinstance(header, dict) else None!r}"
    payload = blob[header_end:]
    actual = hashlib.sha256(payload).hexdigest()
    if actual != header.get("payload_sha256"):
        return header, payload, (
            f"payload digest mismatch (recorded {str(header.get('payload_sha256'))[:12]}…, recomputed "
            f"{actual[:12]}…) — bit rot or torn write"
        )
    return header, payload, None


def _library_version() -> str:
    from .. import __version__

    return __version__


def compile_uncached(compile_fn: Callable[[], Any]) -> Any:
    """Run one compile with the persistent program cache bypassed: here,
    ``compile_fn()`` called once and its result returned.  The JAX package
    turns off XLA's disk cache around the call, because an executable
    served from that cache serializes to an incomplete payload.  The port
    has no such cache to bypass: a capture is never served from disk (a
    CUDA graph holds the addresses of the process that captured it), so
    every capture is already made for real."""
    return compile_fn()


def enable_xla_compilation_cache(directory: Union[str, Path]) -> bool:
    """The counterpart, in a torch process, of the JAX package's persistent
    compilation cache: it caches **bytecode, not programs**.  Beyond its
    kernels, a process's cold start is compiling the modules it imports
    (torch's among them, where ``PYTHONDONTWRITEBYTECODE`` is set and
    site-packages hold no bytecode).  This points ``sys.pycache_prefix``
    at ``directory`` and allows bytecode writes, so every process sharing
    the directory compiles a module once; a daemon hands the same prefix
    to its fleet's workers (``PYTHONPYCACHEPREFIX``).  Returns whether the
    configuration took (``False`` when the directory cannot be made)."""
    try:
        Path(directory).mkdir(parents=True, exist_ok=True)
    except OSError:
        return False
    sys.pycache_prefix = str(Path(directory).resolve())
    sys.dont_write_bytecode = False
    return True
