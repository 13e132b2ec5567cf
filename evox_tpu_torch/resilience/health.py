"""Run-health state scan (counterpart of the state scan of
``evox_tpu/resilience/health.py``: :func:`scan_state`, ``_best_fitness_expr``,
``_is_prng`` and ``_subtree``).

:func:`scan_state` is a pure ``state -> {metric: 0-dim tensor}`` function:
every branch is on the structure of the state, every metric stays on the
state's device, so it reads nothing back to the host and runs inside a
captured CUDA graph.  Metric names and leaf-path names are the JAX
package's (``"algorithm/pop"``: the keys of the nested states, joined by
``/``).  ``HealthProbe``/``HealthReport`` are not ported yet.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping, Sequence

import torch

__all__ = ["scan_state"]


def _is_prng(leaf: Any, name: str | None = None) -> bool:
    """Whether ``leaf`` is a PRNG key.  JAX's keys carry a key dtype; a port
    key is a plain int64 tensor whose last axis holds its two words, so it
    is told apart by where it sits: a leaf whose path (as
    :func:`_leaves_with_path` names it) ends in ``key``, the name every
    component of the port gives its key (``utils.convert.state_from_numpy``
    reads keys the same way).  Without a path nothing is one (a key is
    skipped as a non-floating leaf all the same)."""
    return (
        name is not None
        and name.rsplit("/", 1)[-1] == "key"
        and isinstance(leaf, torch.Tensor)
        and leaf.dtype == torch.int64
        and leaf.ndim >= 1
        and leaf.shape[-1] == 2
    )


def _subtree(state: Any, name: str) -> Any | None:
    """``state[name]`` when ``state`` is a mapping that has it, else None."""
    if isinstance(state, Mapping) and name in state:
        return state[name]
    return None


def _leaves_with_path(tree: Any, prefix: tuple = ()) -> Iterator[tuple[str, Any]]:
    """``(path, leaf)`` in the order the JAX package flattens a state: the
    keys of each mapping in order, the items of tuples and lists by index,
    joined with ``/``."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves_with_path(v, prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _floating(x: Any) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def scan_state(
    state: Any,
    *,
    check_nonfinite: bool = True,
    nonfinite_skip: Sequence[str] = (),
    diversity: bool = False,
    step_size: bool = False,
    shards: int | None = None,
) -> dict[str, Any]:
    """Pure ``state -> {metric: 0-dim tensor}`` health scan; keys are
    emitted only when the state supports them, so the dict is stable per
    state structure:

    * ``nonfinite`` — per-leaf-path counts (int32) of NaN/±Inf scalars
      (floating leaves only; ``nonfinite_skip`` matches excluded);
    * ``diversity`` — largest per-dimension std of ``algorithm.pop``;
    * ``step_size_min`` / ``step_size_max`` — extrema of ``algorithm.sigma``;
    * ``best_fitness`` — monitor top-k best (minimizing frame) when
      available, else ``min(algorithm.fit)``;
    * ``shard_nonfinite`` / ``shard_rows`` / ``shard_diversity`` — with
      ``shards=N > 1``, the non-finite rows of ``algorithm.fit`` and the
      rows of each shard (int32 ``(N,)``), and, with ``diversity``, the
      largest per-dimension spread of each shard's rows of
      ``algorithm.pop`` (``inf`` for a shard with no rows).  Shards are the
      contiguous row blocks of
      :func:`~evox_tpu_torch.parallel.shard_row_ids`, ragged tails
      included.
    """
    out: dict[str, Any] = {}
    if check_nonfinite:
        counts = {}
        for name, leaf in _leaves_with_path(state):
            if any(skip in name for skip in nonfinite_skip):
                continue
            if _is_prng(leaf) or not _floating(leaf):
                continue
            counts[name] = (~torch.isfinite(leaf)).sum(dtype=torch.int32)
        out["nonfinite"] = counts
    algo = _subtree(state, "algorithm")
    algo = algo if algo is not None else state
    pop = _subtree(algo, "pop")
    if diversity and _floating(pop) and pop.ndim == 2:
        # Largest per-dimension spread (population std, two passes, as
        # jnp.std): below a floor means EVERY dimension collapsed.
        centered = pop - pop.mean(dim=0)
        out["diversity"] = torch.amax(torch.sqrt((centered * centered).mean(dim=0)))
    fit = _subtree(algo, "fit")
    if shards and shards > 1 and _floating(fit) and fit.ndim in (1, 2):
        # Per shard: a shard whose count equals its rows is dead.
        from ..parallel import shard_row_ids

        ids = shard_row_ids(fit.shape[0], shards, fit.device)
        row_bad = ~torch.isfinite(fit)
        if fit.ndim == 2:
            row_bad = row_bad.any(dim=-1)
        zeros = torch.zeros((shards,), dtype=torch.int32, device=fit.device)
        out["shard_nonfinite"] = zeros.index_add(0, ids, row_bad.to(torch.int32))
        out["shard_rows"] = zeros.index_add(0, ids, torch.ones_like(ids, dtype=torch.int32))
    if diversity and shards and shards > 1 and _floating(pop) and pop.ndim == 2:
        from ..parallel import shard_row_ids

        ids = shard_row_ids(pop.shape[0], shards, pop.device)
        zeros = torch.zeros((shards,) + tuple(pop.shape[1:]), dtype=pop.dtype, device=pop.device)
        n_s = torch.zeros((shards,), dtype=pop.dtype, device=pop.device).index_add(
            0, ids, torch.ones((pop.shape[0],), dtype=pop.dtype, device=pop.device)
        )
        denom = torch.clamp(n_s, min=1.0)[:, None]
        mean = zeros.index_add(0, ids, pop) / denom
        # Two passes (centered), as the whole-population spread.
        centered = pop - mean[ids]
        var = zeros.index_add(0, ids, centered * centered) / denom
        spread = torch.amax(torch.sqrt(var), dim=-1)
        out["shard_diversity"] = torch.where(n_s > 0, spread, torch.full_like(spread, float("inf")))
    sigma = _subtree(algo, "sigma")
    if step_size and _floating(sigma):
        out["step_size_min"] = torch.amin(sigma)
        out["step_size_max"] = torch.amax(sigma)
    best = _best_fitness_expr(state, algo)
    if best is not None:
        out["best_fitness"] = best
    return out


def _best_fitness_expr(state: Any, algo: Any):
    """Best fitness in the minimizing frame: the monitor's running top-k
    when present (monotone best-so-far), else this generation's
    ``min(fit)``.  ``None`` when the state exposes neither (e.g.
    multi-objective states, which have no scalar best)."""
    mon = _subtree(state, "monitor")
    if mon is not None:
        topk = _subtree(mon, "topk_fitness")
        if _floating(topk) and topk.ndim == 1 and topk.numel() > 0:
            return topk[0]
    fit = _subtree(algo, "fit")
    if _floating(fit) and fit.ndim == 1 and fit.numel() > 0:
        return torch.amin(fit)
    return None
