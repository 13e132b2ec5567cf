"""FS-PSO's best fitness a generation, at its default mutate rate and at 1/D.

Run from the root of a checkout, on the CPU:

    JAX_PLATFORMS=cpu python3 -m tools.fspso_mutate_rate --framework jax
    python3 -m tools.fspso_mutate_rate --framework torch

It runs ``FSPSO(pop, ±10 in dim 1000)`` on Sphere, float32, through the
JAX package (``--framework jax``, jitted steps) or through the PyTorch port
on the CPU (``--framework torch``), for each ``--mutate-rate`` (default:
the algorithm's 0.01 and 1/D), and prints one JSON line a run: the best
fitness the state holds (the current, local and global bests) after
``init_step`` and after each generation, and the generations after which
that best last fell.  Only the framework asked for is imported.
"""

from __future__ import annotations

import argparse
import json
import time


def best_jax(st) -> float:
    import jax.numpy as jnp

    return float(jnp.minimum(jnp.min(st.fit), jnp.minimum(jnp.min(st.local_best_fit), st.global_best_fit)))


def run_jax(pop: int, dim: int, rate: float, gens: int, seed: int) -> list[float]:
    import jax
    import jax.numpy as jnp

    from evox_tpu.algorithms import FSPSO
    from evox_tpu.problems.numerical import Sphere
    from evox_tpu.workflows import StdWorkflow

    lb, ub = jnp.full((dim,), -10.0), jnp.full((dim,), 10.0)
    wf = StdWorkflow(FSPSO(pop, lb, ub, mutate_rate=rate), Sphere())
    state = wf.init_step(wf.setup(jax.random.key(seed)))
    step = jax.jit(wf.step)
    out = [best_jax(state.algorithm)]
    for _ in range(gens):
        state = step(state)
        out.append(best_jax(state.algorithm))
    return out


def run_torch(pop: int, dim: int, rate: float, gens: int, seed: int) -> list[float]:
    import torch

    from evox_tpu_torch.algorithms import FSPSO
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows import StdWorkflow

    lb, ub = torch.full((dim,), -10.0), torch.full((dim,), 10.0)
    wf = StdWorkflow(FSPSO(pop, lb, ub, mutate_rate=rate, device="cpu"), Sphere())

    def best(st) -> float:
        return float(torch.cat([st.fit, st.local_best_fit, st.global_best_fit.reshape(1)]).min())

    state = wf.init_step(wf.init(seed))
    out = [best(state.algorithm)]
    for _ in range(gens):
        state = wf.step(state)
        out.append(best(state.algorithm))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--framework", choices=("jax", "torch"), required=True)
    ap.add_argument("--pop", type=int, default=10000)
    ap.add_argument("--dim", type=int, default=1000)
    ap.add_argument("--gens", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mutate-rate", type=float, nargs="*", default=None,
                    help="rates to run (default: 0.01 and 1/dim)")
    args = ap.parse_args()
    rates = args.mutate_rate or [0.01, 1.0 / args.dim]
    run = run_jax if args.framework == "jax" else run_torch
    for rate in rates:
        t0 = time.perf_counter()
        best = run(args.pop, args.dim, rate, args.gens, args.seed)
        fell = [g for g in range(1, len(best)) if best[g] < best[g - 1]]
        print(json.dumps({
            "framework": args.framework, "pop": args.pop, "dim": args.dim, "mutate_rate": rate,
            "seed": args.seed, "generations": args.gens, "best_after_init_step": best[0],
            "best_last": best[-1], "generations_where_best_fell": fell, "best": best,
            "seconds": time.perf_counter() - t0,
        }), flush=True)


if __name__ == "__main__":
    main()
