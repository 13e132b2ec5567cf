"""Checkpoint / resume for workflow state (counterpart of
``evox_tpu/utils/checkpoint.py``, with its on-disk format).

A checkpoint is the tensor leaves of a state nest, keyed by path, in one
``.npz`` file: the JAX package's format exactly, so each package's
:func:`verify_checkpoint` accepts the other's archives.

* Leaves are keyed by the JAX package's path strings: the keys of each
  mapping (``State`` or dict), the index of each tuple/list item, ``.name``
  for a NamedTuple field, joined by ``/`` (``"algorithm/pop"``).
* A ``__manifest__`` entry (JSON, ``format`` :data:`CHECKPOINT_FORMAT`)
  records the generation, the library and torch versions, the leaf count,
  the wall clock, the ``topology`` the archive was written on
  (:mod:`evox_tpu_torch.resilience.elastic`), the ``key_impl`` of the
  state's keys and a SHA-256 digest of every entry (over its ``dtype.str``,
  shape and bytes); a ``__digest__`` entry guards the manifest.  A
  ``precision`` tag rides in through ``metadata``
  (``{"precision": precision_tag(policy)}``), as the JAX package's
  resilience runner writes it.
* bfloat16 leaves are stored as a ``__bf16__/``-tagged uint16 bit view (the
  card has no ``ml_dtypes``, and numpy has no bfloat16).
* The port's keys (``int64 [seed, counter]`` tensors, see
  :mod:`evox_tpu_torch.utils.rng`) are stored under :data:`KEY_PREFIX`, a
  tag of their own: they are not the JAX package's key data (its
  ``__key__/`` entries) and neither package loads the other's.  The
  manifest's ``key_impl`` names their stream family.

Writes are atomic (a temp file in the target directory, ``os.replace``d
into place); with ``durable=True`` the file is fsynced before the rename
and the directory after it.  Every file-system touch goes through a
:class:`CheckpointStore`.  :class:`AsyncCheckpointWriter` moves the copy to
the host, the digests and the publish to a background thread.

Tensors on the card are copied to the host once per leaf;
:func:`load_state` puts each leaf back on its template leaf's device.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import time
import warnings
import zipfile
import zlib
from pathlib import Path
from typing import Any, Callable, Iterator, Mapping, Union

import numpy as np
import torch

from . import graph

__all__ = [
    "save_state",
    "atomic_write_text",
    "load_state",
    "read_manifest",
    "verify_checkpoint",
    "quarantine_target",
    "CheckpointError",
    "CheckpointCorruptError",
    "CheckpointStore",
    "ReadOnlyCheckpointStore",
    "AsyncCheckpointWriter",
]

MANIFEST_KEY = "__manifest__"
DIGEST_KEY = "__digest__"
BF16_PREFIX = "__bf16__/"
# The JAX package's typed-key entries; the port never writes one.
JAX_KEY_PREFIX = "__key__/"
# The port's keys: int64 [seed, counter] words, not JAX key data.
KEY_PREFIX = "__torch_key__/"
CHECKPOINT_FORMAT = 2


class CheckpointError(ValueError):
    """A checkpoint exists but cannot be loaded into the requested template
    (missing leaf, shape mismatch, incompatible dtype, or corrupt archive).
    A :class:`ValueError`, so callers validating user-supplied checkpoint
    paths can catch it generically."""


class CheckpointCorruptError(CheckpointError):
    """The checkpoint's *bytes* are damaged (truncated or torn archive,
    digest mismatch, unreadable zip structure), as opposed to a well-formed
    archive that mismatches the caller's template."""


class CheckpointStore:
    """The file-system operations a checkpoint write performs, as an
    overridable seam (fault injection, other backends)."""

    def open_temp(self, directory: Union[str, Path], prefix: str) -> tuple[int, str]:
        """Create the temp file the archive is staged in; returns
        ``(fd, path)`` like ``tempfile.mkstemp``."""
        return tempfile.mkstemp(dir=directory, prefix=prefix)

    def write_archive(self, f: Any, arrays: dict[str, np.ndarray]) -> None:
        """Serialize ``arrays`` into the open binary file object ``f`` (the
        archive ``np.savez`` writes)."""
        _write_npz(f, arrays)

    def fsync_file(self, f: Any) -> None:
        """Flush ``f`` to stable storage (before the publish of a durable
        write)."""
        f.flush()
        os.fsync(f.fileno())

    def publish(self, tmp: Union[str, Path], final: Union[str, Path]) -> None:
        """Atomically move the staged temp file into place."""
        os.replace(tmp, final)

    def fsync_dir(self, directory: Union[str, Path]) -> None:
        """Flush the directory entry of a just-published file."""
        try:
            fd = os.open(directory, os.O_RDONLY)
        except OSError:  # pragma: no cover - a file system without dir opens
            return
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def unlink(self, path: Union[str, Path]) -> None:
        """Remove a file (temp cleanup, checkpoint GC)."""
        os.unlink(path)

    def rename(self, src: Union[str, Path], dst: Union[str, Path]) -> None:
        """Move a file aside (a ``*.corrupt`` quarantine)."""
        os.replace(src, dst)

    def write_bytes(self, f: Any, data: bytes) -> None:
        """Write a raw byte payload into the open binary file object ``f``."""
        f.write(data)

    def open_append(self, path: Union[str, Path]) -> Any:
        """Open ``path`` for appending; returns a binary file object the
        caller owns."""
        return open(path, "ab")

    def append_record(self, f: Any, data: bytes) -> int:
        """Append one record's bytes to ``f``; returns the byte count."""
        f.write(data)
        return len(data)

    def truncate(self, path: Union[str, Path], size: int) -> None:
        """Cut ``path`` back to ``size`` bytes."""
        os.truncate(path, size)


class ReadOnlyCheckpointStore(CheckpointStore):
    """A store that refuses every mutating operation with
    ``OSError(EROFS)`` (the non-writing side of a single-writer
    discipline: reads never go through the store)."""

    def __init__(self, reason: str = "non-primary fleet process"):
        self.reason = str(reason)

    def _refuse(self, op: str) -> OSError:
        import errno

        return OSError(
            errno.EROFS,
            f"checkpoint store is read-only ({self.reason}): {op} refused — "
            f"only the fleet's primary process mutates the checkpoint "
            f"directory",
        )

    def open_temp(self, directory, prefix):
        raise self._refuse("write")

    def open_append(self, path):
        raise self._refuse(f"append to {path}")

    def truncate(self, path, size):
        raise self._refuse(f"truncate of {path}")

    def publish(self, tmp, final):
        raise self._refuse("publish")

    def unlink(self, path):
        raise self._refuse(f"unlink of {path}")

    def rename(self, src, dst):
        raise self._refuse(f"rename of {src}")


_DEFAULT_STORE = CheckpointStore()
# Entries from this size on are written in one call (see _write_npz).
_WHOLE_WRITE_BYTES = 1 << 20


def _write_npz(f: Any, arrays: dict[str, np.ndarray]) -> None:
    """``np.savez(f, **arrays)``, entry for entry and byte for byte of each
    member, with each large contiguous array written in one call: numpy
    writes a member of a zip file in 16 MiB chunks, each copied under the
    interpreter lock, which stalls the thread driving the card when this
    runs on the async writer's thread; one ``write`` runs the CRC and the
    file write in C calls that release the lock."""
    import zipfile

    from numpy.lib import format as npy

    header = getattr(npy, "_write_array_header", None)
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, val in arrays.items():
            val = np.asanyarray(val)
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if header is None or val.nbytes < _WHOLE_WRITE_BYTES or not val.flags.c_contiguous \
                        or val.dtype.hasobject:
                    npy.write_array(fid, val)
                else:
                    header(fid, npy.header_data_from_array_1_0(val), None)
                    fid.write(val.reshape(-1).view(np.uint8))


def quarantine_target(path: Path) -> Path:
    """First free ``<name>.corrupt[.N]`` destination: a quarantine never
    overwrites earlier evidence."""
    target = path.with_name(path.name + ".corrupt")
    n = 1
    while target.exists():
        target = path.with_name(f"{path.name}.corrupt.{n}")
        n += 1
    return target


def _named_leaves(tree: Any, prefix: tuple = ()) -> Iterator[tuple[str, torch.Tensor]]:
    """``(path, tensor)`` for every tensor leaf, in the order
    :func:`~evox_tpu_torch.utils.graph.flatten` lists them, named as the
    JAX package's ``_path_str`` names a pytree path."""
    if isinstance(tree, torch.Tensor):
        yield "/".join(prefix), tree
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _named_leaves(v, prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _named_leaves(v, prefix + ("." + k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, prefix + (str(i),))


def _is_key(name: str, leaf: torch.Tensor) -> bool:
    """A port key: an int64 leaf named ``key`` whose last axis holds the two
    words (as the health scan tells keys apart)."""
    return name.rsplit("/", 1)[-1] == "key" and leaf.dtype == torch.int64 and leaf.ndim >= 1 and leaf.shape[-1] == 2


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """The host copy of a leaf (one copy from the card per leaf)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _entry_digest(arr: np.ndarray) -> str:
    """SHA-256 over an archive entry's dtype, shape and raw bytes (the
    JAX package's definition)."""
    arr = np.asarray(arr)
    h = hashlib.sha256()
    h.update(arr.dtype.str.encode())
    h.update(str(arr.shape).encode())
    # The bytes as a view, not a copy: hashlib releases the interpreter
    # lock over a large buffer.
    h.update(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    return h.hexdigest()


def _archive_entries(state: Any) -> tuple[dict[str, np.ndarray], torch.Tensor | None]:
    """The archive's leaf entries of ``state`` and its first key leaf."""
    out: dict[str, np.ndarray] = {}
    first_key = None
    for name, leaf in _named_leaves(state):
        if _is_key(name, leaf):
            out[KEY_PREFIX + name] = _to_numpy(leaf)
            if first_key is None:
                first_key = leaf
        elif leaf.dtype == torch.bfloat16:
            out[BF16_PREFIX + name] = _to_numpy(leaf)
        else:
            out[name] = _to_numpy(leaf)
    return out, first_key


def save_state(
    path: Union[str, Path],
    state: Any,
    *,
    generation: int | None = None,
    metadata: dict[str, Any] | None = None,
    store: CheckpointStore | None = None,
    durable: bool = False,
) -> Path:
    """Save a (nested) State / nest of tensors to ``path`` as ``.npz``
    (a suffix-less ``path`` gains ``.npz``); returns the path written.

    The write is atomic (temp file + ``os.replace``).  The manifest records
    a SHA-256 digest per entry and the archive a digest of the manifest, so
    :func:`verify_checkpoint` / ``load_state(verify=True)`` detect damaged
    bytes later.  Only tensor leaves are stored; everything else of the
    nest is the template's on load.

    :param generation: optional generation number for the manifest.
    :param metadata: optional extra JSON-serializable manifest entries (a
        ``precision`` tag: ``{"precision": precision_tag(policy)}``).
    :param store: the :class:`CheckpointStore` doing the file operations.
    :param durable: fsync the archive before the rename and the directory
        after it, so the publish survives power loss.
    """
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_name(path.name + ".npz")
    store = store if store is not None else _DEFAULT_STORE
    out, first_key = _archive_entries(state)
    manifest = {
        "format": CHECKPOINT_FORMAT,
        "generation": None if generation is None else int(generation),
        "evox_tpu_version": _library_version(),
        "torch_version": torch.__version__,
        "n_leaves": len(out),
        "written_at": time.time(),
        "topology": _environment_topology(),
        "leaf_digests": {name: _entry_digest(arr) for name, arr in out.items()},
    }
    if first_key is not None:
        from ..precision import key_impl_name

        manifest["key_impl"] = key_impl_name(first_key)
        manifest["key_format"] = KEY_PREFIX
    if metadata:
        manifest.update(metadata)
    manifest_json = json.dumps(manifest)
    out[MANIFEST_KEY] = np.array(manifest_json)
    out[DIGEST_KEY] = np.array(hashlib.sha256(manifest_json.encode()).hexdigest())
    _publish(path, lambda f: store.write_archive(f, out), store, durable, "wb")
    return path


def _publish(path: Path, write: Callable[[Any], None], store: CheckpointStore, durable: bool, mode: str) -> None:
    """Stage ``write``'s output in a temp file beside ``path`` and rename it
    into place (fsyncs when ``durable``); no temp file is left on failure."""
    parent = path.parent or Path(".")
    fd, tmp = store.open_temp(parent, path.name + ".tmp.")
    try:
        with os.fdopen(fd, mode) as f:
            write(f)
            if durable:
                store.fsync_file(f)
        store.publish(tmp, path)
        if durable:
            store.fsync_dir(parent)
    except BaseException:
        try:
            store.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_text(
    path: Union[str, Path],
    text: str,
    *,
    durable: bool = False,
    store: CheckpointStore | None = None,
) -> Path:
    """Publish ``text`` at ``path`` atomically through the
    :class:`CheckpointStore` seam (temp file in the same directory,
    ``os.replace`` into place, optional file and directory fsync)."""
    path = Path(path)
    _publish(path, lambda f: f.write(text), store if store is not None else _DEFAULT_STORE, durable, "w")
    return path


def _library_version() -> str:
    from .. import __version__

    return __version__


def _environment_topology() -> dict[str, Any]:
    """Manifest form of the process's device world (a lazy import: the
    elastic module imports :class:`CheckpointError` from here)."""
    from ..resilience.elastic import current_topology

    return current_topology().to_manifest()


def _resolve(path: Union[str, Path]) -> Path:
    # save_state appends ``.npz`` to suffix-less paths: accept the same
    # path string here.
    path = Path(path)
    if not path.exists():
        alt = path.with_name(path.name + ".npz")
        if alt.exists():
            return alt
    return path


def read_manifest(path: Union[str, Path]) -> dict[str, Any]:
    """The ``__manifest__`` entry of a checkpoint written by
    :func:`save_state`.  A truncated or torn archive raises
    :class:`CheckpointCorruptError`, an archive without a manifest
    :class:`CheckpointError`; only a missing file raises
    ``FileNotFoundError``."""
    path = _resolve(path)
    try:
        with np.load(path) as data:
            if MANIFEST_KEY not in data:
                raise CheckpointError(
                    f"checkpoint {path} has no {MANIFEST_KEY} entry — not "
                    f"written by save_state (or written by a pre-manifest "
                    f"version)"
                )
            return json.loads(str(data[MANIFEST_KEY]))
    except (CheckpointError, FileNotFoundError):
        raise
    except Exception as e:
        raise CheckpointCorruptError(f"checkpoint {path} is unreadable: {e!r}") from e


def _verify_archive(path: Path, data: Any, leaves: bool = True) -> dict[str, Any]:
    """Digest-check an open npz archive; returns the verified manifest.
    ``leaves=False`` checks the manifest's digest and the archive's entry
    list only."""
    if MANIFEST_KEY not in data:
        raise CheckpointError(
            f"checkpoint {path} has no {MANIFEST_KEY} entry — not written "
            f"by save_state; nothing to verify against"
        )
    try:
        manifest_json = str(data[MANIFEST_KEY])
        manifest = json.loads(manifest_json)
        digests = manifest.get("leaf_digests")
        if digests is None:
            warnings.warn(
                f"checkpoint {path} predates per-leaf digests (format "
                f"{manifest.get('format')}); integrity cannot be verified"
            )
            return manifest
        if DIGEST_KEY not in data:
            raise CheckpointCorruptError(
                f"checkpoint {path}: manifest digest entry {DIGEST_KEY} is "
                f"missing from a format-{manifest.get('format')} archive"
            )
        recorded = str(data[DIGEST_KEY])
        actual = hashlib.sha256(manifest_json.encode()).hexdigest()
        if recorded != actual:
            raise CheckpointCorruptError(
                f"checkpoint {path}: manifest digest mismatch (recorded "
                f"{recorded[:12]}…, recomputed {actual[:12]}…) — the "
                f"manifest bytes are damaged"
            )
        names = [n for n in data.files if n not in (MANIFEST_KEY, DIGEST_KEY)]
        if sorted(names) != sorted(digests):
            missing = sorted(set(digests) - set(names))
            extra = sorted(set(names) - set(digests))
            raise CheckpointCorruptError(
                f"checkpoint {path}: archive entries do not match the "
                f"manifest (missing {missing!r}, unexpected {extra!r}) — "
                f"torn or tampered archive"
            )
        if leaves:
            for name in names:
                actual = _entry_digest(data[name])
                if actual != digests[name]:
                    raise CheckpointCorruptError(
                        f"checkpoint {path}: leaf {name!r} digest mismatch "
                        f"(recorded {digests[name][:12]}…, recomputed "
                        f"{actual[:12]}…) — bit rot or torn write"
                    )
    except CheckpointError:
        raise
    except Exception as e:
        raise CheckpointCorruptError(f"checkpoint {path} is unreadable: {e!r}") from e
    return manifest


def verify_checkpoint(path: Union[str, Path], *, leaves: bool = True) -> dict[str, Any]:
    """Integrity-check a checkpoint without a template: every entry's
    SHA-256 against the manifest's ``leaf_digests``, and the manifest's own
    digest against ``__digest__``.  Returns the verified manifest; raises
    :class:`CheckpointCorruptError` on damaged bytes and
    :class:`CheckpointError` on an archive without a manifest.  (``zipfile``'s
    CRC-32 does not cover this: ``np.load`` streams members without
    reaching the CRC check.)

    :param leaves: recompute the per-entry digests (the full pass over the
        archive's bytes); ``False`` checks only that the archive opens, its
        manifest's digest and that it lists exactly the manifest's entries.
    """
    path = _resolve(path)
    try:
        with np.load(path) as data:
            return _verify_archive(path, data, leaves=leaves)
    except (CheckpointError, FileNotFoundError):
        raise
    except Exception as e:
        raise CheckpointCorruptError(f"checkpoint {path} is unreadable: {e!r}") from e


_UNSET = object()
# Storage dtypes of a PrecisionPolicy: never crossed by a silent cast.
_NARROW = (np.dtype(np.float16), np.dtype(np.uint16))


def load_state(
    path: Union[str, Path],
    like: Any,
    allow_missing: bool = False,
    *,
    mesh: Any | None = None,
    remesh: bool = True,
    verify: bool = False,
    precision: Any = _UNSET,
    key_impl: Any = _UNSET,
) -> Any:
    """Load a checkpoint written by :func:`save_state` (by this package or
    the JAX package) into the structure of ``like`` (a template state, e.g.
    a fresh ``setup()`` state); returns a new nest, ``like`` unchanged.
    Each leaf lands on its template leaf's device.

    Every mismatch raises a :class:`CheckpointError` naming the leaf:

    * a leaf missing from the archive (unless ``allow_missing``: the
      template's value is kept, with a warning);
    * a shape mismatch — except for a size-0 template leaf, a placeholder
      that adopts the stored shape;
    * a dtype that cannot be cast ``same_kind`` (a width change such as
      float64 -> float32 is cast; float -> int is refused), or that crosses
      a narrow storage dtype (float16, bfloat16) either way;
    * a JAX package key where the template holds a port key (the streams
      differ by construction).

    :param mesh: the :class:`~evox_tpu_torch.parallel.PopMesh` the loaded
        state runs under: the archive's recorded topology is checked
        against it before any leaf is restored (``remesh=False`` makes a
        mesh mismatch a :class:`CheckpointError`), and the state is placed
        for it (:func:`~evox_tpu_torch.resilience.elastic.remesh_state`).
    :param remesh: allow loading across a topology change.
    :param verify: digest-check the whole archive first
        (:func:`verify_checkpoint`).
    :param precision: when passed (a
        :class:`~evox_tpu_torch.precision.PrecisionPolicy` or ``None`` for
        full precision), the archive's ``precision`` tag must match it
        (:func:`~evox_tpu_torch.precision.check_precision`).
    :param key_impl: when passed (a name or ``None`` for the default), the
        archive's ``key_impl`` must match it.
    """
    path = _resolve(path)
    try:
        data = np.load(path)
    except FileNotFoundError:
        raise
    except Exception as e:
        raise CheckpointCorruptError(f"checkpoint {path} is unreadable: {e!r}") from e
    with data:
        if verify:
            _verify_archive(path, data)
        manifest: dict[str, Any] = {}
        if precision is not _UNSET or key_impl is not _UNSET or mesh is not None:
            manifest = json.loads(str(data[MANIFEST_KEY])) if MANIFEST_KEY in data else {}
        if precision is not _UNSET:
            from ..precision import check_precision

            check_precision(manifest.get("precision"), precision, context=f"checkpoint {path}")
        if key_impl is not _UNSET:
            from ..precision import resolve_key_impl
            from ..precision.prng import DEFAULT_KEY_IMPL

            # An archive without a key_impl entry was written on the
            # literal default (never the environment's).
            recorded_impl = manifest.get("key_impl") or DEFAULT_KEY_IMPL
            expected_impl = resolve_key_impl(key_impl)
            if recorded_impl != expected_impl:
                raise CheckpointError(
                    f"checkpoint {path}: PRNG key-impl mismatch — the "
                    f"archive was written with {recorded_impl!r} but "
                    f"this run is configured for {expected_impl!r}. "
                    f"Streams differ across implementations by "
                    f"construction; resume with the matching key_impl "
                    f"or re-seed the run."
                )
        if mesh is not None and MANIFEST_KEY in data:
            from ..resilience.elastic import MeshTopology, check_topology

            check_topology(
                manifest.get("topology"), MeshTopology.from_mesh(mesh), remesh=remesh, context=f"checkpoint {path}"
            )
        try:
            state = _restore_leaves(path, data, like, allow_missing)
        except CheckpointError:
            raise
        except (zipfile.BadZipFile, zlib.error, EOFError, OSError) as e:
            raise CheckpointCorruptError(f"checkpoint {path} is unreadable: {e!r}") from e
    if mesh is not None:
        from ..resilience.elastic import remesh_state

        state = remesh_state(state, mesh)
    return state


def _cast(path: Path, name: str, arr: np.ndarray, want: np.dtype) -> np.ndarray:
    if arr.dtype == want:
        return arr
    if not np.can_cast(arr.dtype, want, casting="same_kind"):
        raise CheckpointError(
            f"checkpoint {path}: leaf {name!r} has dtype {arr.dtype}, which cannot be safely cast to the "
            f"template's {want}"
        )
    return arr.astype(want)


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype an archive stores a torch dtype as (bfloat16: its
    uint16 bit view)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty((), dtype=dtype).numpy().dtype


def _restore_key(path: Path, data: Any, name: str, leaf: torch.Tensor, allow_missing: bool) -> torch.Tensor:
    if KEY_PREFIX + name in data:
        raw = data[KEY_PREFIX + name]
        if raw.dtype != np.int64 or tuple(raw.shape) != tuple(leaf.shape):
            raise CheckpointError(
                f"checkpoint {path}: key leaf {name!r} has stored {raw.dtype}{list(raw.shape)}, "
                f"but the template expects int64{list(leaf.shape)}"
            )
        return torch.from_numpy(raw if raw.flags.writeable else raw.copy()).to(leaf.device)
    if JAX_KEY_PREFIX + name in data or name in data:
        raise CheckpointError(
            f"checkpoint {path}: key leaf {name!r} holds key data that is not the port's (the JAX package's "
            f"keys draw other streams); re-seed the run"
        )
    if allow_missing:
        warnings.warn(f"checkpoint {path} has no entry for state leaf {name!r}; keeping the template value")
        return leaf
    raise CheckpointError(f"checkpoint {path} has no entry for state leaf {name!r}")


def _restore_leaves(path: Path, data: Any, like: Any, allow_missing: bool) -> Any:
    _, spec = graph.flatten(like)
    new_leaves = []
    for name, leaf in _named_leaves(like):
        if _is_key(name, leaf):
            new_leaves.append(_restore_key(path, data, name, leaf, allow_missing))
            continue
        narrow = leaf.dtype in (torch.bfloat16, torch.float16)
        if BF16_PREFIX + name in data:
            arr, stored = data[BF16_PREFIX + name], "bfloat16"
        elif name in data:
            arr = data[name]
            stored = str(arr.dtype)
        elif allow_missing:
            warnings.warn(f"checkpoint {path} has no entry for state leaf {name!r}; keeping the template value")
            new_leaves.append(leaf)
            continue
        else:
            raise CheckpointError(
                f"checkpoint {path} has no entry for state leaf {name!r} "
                f"(pass allow_missing=True to keep the template value for "
                f"leaves added since the checkpoint was written)"
            )
        want = str(leaf.dtype).split(".")[-1]
        if (narrow or stored in ("bfloat16", "float16")) and stored != want:
            raise CheckpointError(
                f"checkpoint {path}: leaf {name!r} crosses a precision boundary (stored {stored}, template "
                f"{want}) — a bfloat16 checkpoint must be loaded under the matching PrecisionPolicy, never "
                f"silently cast"
            )
        if tuple(arr.shape) != tuple(leaf.shape) and leaf.numel() != 0:
            raise CheckpointError(
                f"checkpoint {path}: leaf {name!r} has shape "
                f"{tuple(arr.shape)}, but the template expects "
                f"{tuple(leaf.shape)} — was it written with a different "
                f"pop size / dim / config?"
            )
        # A size-0 template leaf is a placeholder: it adopts the stored
        # shape (the dtype goes through the same checks).
        arr = _cast(path, name, arr, _numpy_dtype(leaf.dtype))
        t = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
        if leaf.dtype == torch.bfloat16:
            t = t.view(torch.int16).view(torch.bfloat16)
        new_leaves.append(t.to(leaf.device))
    return graph.unflatten(spec, new_leaves)


class AsyncCheckpointWriter:
    """Background checkpoint writer: the copy to the host, the digests and
    the atomic publish run on one daemon thread, so the submitting (device
    loop) thread does not wait for them.

    **At most one write is in flight.**  :meth:`submit` waits for the
    previous write, hands the new one off and returns.  The state's tensors
    are read by the writer thread after the work that made them: the
    submitting stream records an event, the writer's side stream waits on
    it and copies each leaf into pinned host buffers, so the copies overlap
    the caller's next generations on the card.  The buffers (a state's size
    of pinned host memory) are allocated at the first write, which stalls
    the card's work while they are, and kept until :meth:`close`.  The caller must not modify the
    submitted tensors in place until the write is done (the workflows'
    steps never do: every generation makes new tensors).

    A failed write never raises into the caller: it is recorded, reported
    through ``on_error`` and returned by :meth:`pop_errors`.
    ``on_published`` runs on the writer thread after the publish.  The
    worker thread starts on the first submit and exits after
    ``idle_timeout`` seconds without work (restarted by the next submit).

    :param store: the :class:`CheckpointStore` for the file operations.
    :param durable: fsync file and directory on publish (default True).
    :param on_error: ``callable(path, exception)``, on the writer thread.
    :param idle_timeout: idle seconds after which the worker thread exits.
    :param registry: optional metrics registry (``counter(name, help)
        .inc(amount)``, ``histogram(name, help).observe(value)``): publishes,
        failures, write seconds and the seconds callers were blocked.
    """

    def __init__(
        self,
        *,
        store: CheckpointStore | None = None,
        durable: bool = True,
        on_error: Callable[[Path, BaseException], None] | None = None,
        idle_timeout: float = 5.0,
        registry: Any | None = None,
    ):
        self._store = store if store is not None else _DEFAULT_STORE
        self._durable = bool(durable)
        self._on_error = on_error
        self._idle_timeout = float(idle_timeout)
        self._registry = registry
        self._cv = threading.Condition()
        self._job: tuple | None = None
        self._busy = False
        self._closed = False
        self._stopping = False
        self._thread: threading.Thread | None = None
        self._errors: list[tuple[Path, BaseException]] = []
        self._streams: dict[torch.device, Any] = {}
        # Pinned host buffers of the last written state's card tensors.
        self._pinned: list[torch.Tensor] = []
        self._pinned_signature: tuple = ()
        self.writes_completed = 0

    # -- worker ------------------------------------------------------------
    def _ensure_thread(self) -> None:
        """Start (or restart after an idle exit) the worker.  The worker
        clears ``_thread`` under the lock when it commits to exit, so an
        enqueue after that starts a new one."""
        with self._cv:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._loop, name="evox-tpu-torch-ckpt-writer", daemon=True)
                self._thread.start()

    def _loop(self) -> None:
        while True:
            with self._cv:
                deadline = time.monotonic() + self._idle_timeout
                while self._job is None and not self._closed and not self._stopping:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        self._thread = None
                        return
                    self._cv.wait(remaining)
                if self._job is None:
                    self._thread = None
                    return
                job = self._job
                self._job = None
                self._busy = True
            path, state, generation, metadata, on_published, ready = job
            t0 = time.perf_counter()
            try:
                save_state(
                    path,
                    self._host_copy(state, ready),
                    generation=generation,
                    metadata=metadata,
                    store=self._store,
                    durable=self._durable,
                )
                self.writes_completed += 1
                self._metric("evox_checkpoint_publishes_total", "Checkpoints durably published by the async writer.")
                self._observe(
                    "evox_checkpoint_write_seconds",
                    time.perf_counter() - t0,
                    "Serialize+digest+durable-publish seconds per write.",
                )
                if on_published is not None:
                    on_published()
            except BaseException as e:  # noqa: BLE001 - reported, not raised
                self._errors.append((Path(path), e))
                self._metric(
                    "evox_checkpoint_publish_failures_total", "Checkpoint writes that failed on the writer thread."
                )
                if self._on_error is not None:
                    try:
                        self._on_error(Path(path), e)
                    except Exception:  # pragma: no cover - a broken reporter
                        pass
            finally:
                state = None
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def _host_copy(self, state: Any, ready: dict) -> Any:
        """``state`` with its card tensors copied into pinned host buffers
        on a side stream of the writer's, after the submitting stream's
        event.  A copy into pageable memory stalls the thread driving the
        card for as long as it runs, and so does allocating pinned memory:
        the buffers are allocated at the first write of a state's structure
        and reused by every later one (at most one write is in flight)."""
        leaves, spec = graph.flatten(state)
        signature = tuple((tuple(t.shape), t.dtype) for t in leaves if t.device.type == "cuda")
        if signature != self._pinned_signature:
            self._pinned = [torch.empty(shape, dtype=dtype, pin_memory=True) for shape, dtype in signature]
            self._pinned_signature = signature
        buffers = iter(self._pinned)
        out = []
        for t in leaves:
            if t.device.type == "cuda":
                stream = self._streams.get(t.device)
                if stream is None:
                    stream = self._streams[t.device] = torch.cuda.Stream(t.device)
                stream.wait_event(ready[t.device])
                host = next(buffers)
                with torch.cuda.stream(stream):
                    host.copy_(t, non_blocking=True)
                t = host
            out.append(t)
        for stream in self._streams.values():
            stream.synchronize()
        return graph.unflatten(spec, out)

    # -- metrics -----------------------------------------------------------
    def _metric(self, name: str, help: str = "", amount: float = 1.0) -> None:
        if self._registry is None:
            return
        try:
            self._registry.counter(name, help).inc(amount)
        except Exception:  # pragma: no cover - a broken registry
            pass

    def _observe(self, name: str, value: float, help: str = "") -> None:
        if self._registry is None:
            return
        try:
            self._registry.histogram(name, help).observe(value)
        except Exception:  # pragma: no cover - a broken registry
            pass

    # -- caller side -------------------------------------------------------
    def submit(
        self,
        path: Union[str, Path],
        state: Any,
        *,
        generation: int | None = None,
        metadata: dict[str, Any] | None = None,
        on_published: Callable[[], None] | None = None,
    ) -> None:
        """Enqueue one checkpoint write.  Blocks only while a previous write
        is in flight, then returns without waiting for this one."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointWriter is closed")
        t0 = time.perf_counter()
        with self._cv:
            while self._job is not None or self._busy:
                self._cv.wait()
        # An event on each card's current stream: the writer reads the
        # tensors after the work enqueued so far.
        ready = {}
        for t in graph.flatten(state)[0]:
            if t.device.type == "cuda" and t.device not in ready:
                ready[t.device] = torch.cuda.Event()
                ready[t.device].record(torch.cuda.current_stream(t.device))
        with self._cv:
            self._job = (Path(path), state, generation, metadata, on_published, ready)
            self._cv.notify_all()
        self._metric(
            "evox_checkpoint_block_seconds_total",
            "Seconds callers spent blocked on submit/barrier waits.",
            amount=time.perf_counter() - t0,
        )
        self._ensure_thread()

    def barrier(self, timeout: float | None = None) -> bool:
        """Wait until no write is pending or in flight; ``False`` on
        timeout."""
        if not self._closed and self._job is not None:
            self._ensure_thread()
        deadline = None if timeout is None else time.monotonic() + timeout
        t0 = time.perf_counter()
        try:
            with self._cv:
                while self._job is not None or self._busy:
                    remaining = None if deadline is None else deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        return False
                    self._cv.wait(remaining)
            return True
        finally:
            self._metric(
                "evox_checkpoint_block_seconds_total",
                "Seconds callers spent blocked on submit/barrier waits.",
                amount=time.perf_counter() - t0,
            )

    def stop(self, timeout: float | None = None) -> bool:
        """Barrier, then end the worker thread and wait for it; unlike
        :meth:`close` the writer stays usable (the next submit starts a new
        thread) and keeps its pinned buffers.  ``False`` on timeout."""
        ok = self.barrier(timeout)
        with self._cv:
            thread = self._thread
            self._stopping = True
            self._cv.notify_all()
        try:
            if thread is not None:
                thread.join(timeout)
                ok = ok and not thread.is_alive()
        finally:
            with self._cv:
                self._stopping = False
        return ok

    def pop_errors(self) -> list[tuple[Path, BaseException]]:
        """Drain and return the ``(path, exception)`` records of failed
        writes."""
        out, self._errors = self._errors, []
        return out

    def close(self, timeout: float | None = None) -> bool:
        """Barrier, then stop the worker thread and release the pinned
        buffers.  Idempotent."""
        ok = self.barrier(timeout)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            if ok:
                self._pinned, self._pinned_signature = [], ()
        return ok
