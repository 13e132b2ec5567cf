"""Supervised-learning fitness: the loss of a population of model weights
(counterpart of ``evox_tpu/problems/neuroevolution/supervised_learning.py``).

Two data paths:

* **Device-resident** (``inputs=``/``labels=``): the dataset lives on the
  device and the batch cursor is part of the problem *state*.  A batch is
  a gather of ``arange(batch_size) + (cursor % num_batches) * batch_size``
  rows, index arithmetic on the device, so an evaluation reads no value on
  the host and a fused segment's CUDA graph holds it; it maps under
  ``torch.func.vmap`` over problem instances.
* **Host-streaming** (``data_source=``): any re-iterable of ``(inputs,
  labels)`` host batches (a ``torch.utils.data.DataLoader`` works as it
  is), pulled from a background producer thread.  Each evaluation takes
  its batches *once* and shares them across the population.  The loader
  position lives on the host, not in the state.  A CUDA graph cannot call
  the host, so on the card a streaming problem refuses fused segments
  (``capturable`` is False: ``StdWorkflow.run``/``run_segment`` raise
  :class:`NotImplementedError` before any batch is pulled); eager steps
  and the CPU's fused segments pull in source order.
"""

from __future__ import annotations

import queue
import threading
import weakref
from typing import Any, Callable, Iterable

import numpy as np
import torch

from ... import resolve_device
from ...core import Problem, State

__all__ = ["SupervisedLearningProblem"]


class SupervisedLearningProblem(Problem):
    """Fitness = criterion(model(inputs), labels) for each candidate weight
    set, over ``n_batch_per_eval`` successive minibatches."""

    def __init__(
        self,
        apply_fn: Callable[[Any, torch.Tensor], torch.Tensor],
        inputs: torch.Tensor | np.ndarray | None = None,
        labels: torch.Tensor | np.ndarray | None = None,
        criterion: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
        batch_size: int | None = None,
        n_batch_per_eval: int = 1,
        reduction: str = "mean",
        data_source: Iterable | None = None,
        prefetch: int = 2,
        device: str | torch.device | None = None,
    ):
        """
        :param apply_fn: pure model forward ``(params, batched_inputs) ->
            predictions`` of one model.
        :param inputs: full input array, leading axis = examples
            (device-resident path; exclusive with ``data_source``).
        :param labels: full label array, aligned with ``inputs``.
        :param criterion: per-example loss ``(pred, label) -> (batch,)`` or
            a scalar loss; non-scalar outputs are reduced per
            ``reduction``.
        :param batch_size: minibatch size; ``None`` uses the whole dataset
            (device-resident path only: streaming batches arrive sized).
        :param n_batch_per_eval: batches consumed per evaluation; ``-1``
            sweeps the whole dataset every evaluation (device-resident
            only).
        :param reduction: ``"mean"`` or ``"sum"`` over examples.
        :param data_source: host-streaming path: any iterable yielding
            ``(inputs, labels)`` batches (numpy arrays, CPU tensors, lists),
            re-iterated from the start when exhausted (epochs).  Batches
            whose shapes differ from the first batch's are skipped.
        :param prefetch: streaming path: batches buffered ahead by the
            producer thread.
        :param device: where the data goes (``None`` means the CUDA card).
        """
        if reduction not in ("mean", "sum"):
            raise ValueError(f"reduction must be 'mean' or 'sum', got {reduction!r}")
        if criterion is None:
            raise ValueError("criterion is required")
        self.apply_fn = apply_fn
        self.reduction = reduction
        self.criterion = criterion
        self.device = resolve_device(device)

        if data_source is not None:
            if inputs is not None or labels is not None:
                raise ValueError(
                    "pass either device-resident inputs/labels or a streaming data_source, not both"
                )
            if n_batch_per_eval < 1:
                raise ValueError("n_batch_per_eval=-1 (full sweep) is undefined for a streaming data_source")
            self.n_batch_per_eval = n_batch_per_eval
            self._init_streaming(data_source, prefetch)
            return

        self.streaming = False
        if inputs is None or labels is None:
            raise ValueError("provide either device-resident inputs/labels or a streaming data_source")
        self.inputs = torch.as_tensor(inputs, device=self.device)
        self.labels = torch.as_tensor(labels, device=self.device)
        n = self.inputs.shape[0]
        if batch_size is None:
            batch_size = n
        if batch_size > n:
            raise ValueError(f"batch_size ({batch_size}) exceeds the dataset size ({n})")
        self.batch_size = batch_size
        self.num_batches = max(n // batch_size, 1)
        if n_batch_per_eval == -1:
            n_batch_per_eval = self.num_batches
        self.n_batch_per_eval = n_batch_per_eval

    @property
    def capturable(self) -> bool:
        """A streaming problem pulls host batches: no CUDA graph holds it."""
        return not self.streaming

    # ---- host-streaming machinery -------------------------------------

    def _init_streaming(self, data_source: Iterable, prefetch: int) -> None:
        self.streaming = True
        self._source = data_source
        self._queue: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._producer_started = False
        # Peek one batch synchronously to learn the fixed batch spec; the
        # producer keeps consuming this same iterator, so the peeked batch
        # is delivered exactly once and in order.
        self._first_iter = iter(data_source)
        first = self._first_batch = self._to_numpy(next(self._first_iter))
        self._batch_dtypes = tuple(a.dtype for a in first)
        self.batch_size = first[0].shape[0]

    @staticmethod
    def _to_numpy(batch) -> tuple[np.ndarray, np.ndarray]:
        x, y = batch
        return np.asarray(x), np.asarray(y)

    # The producer runs in a daemon thread holding only a *weak* reference
    # to the problem: when the problem is garbage-collected the thread
    # notices (at its next 1 s put-timeout) and exits, so a streaming
    # problem does not pin itself and its loader for the process lifetime.
    # A static method, so no bound-method strong reference leaks in.
    @staticmethod
    def _producer(prob_ref, q, source, first_iter, first_batch):
        shapes = (first_batch[0].shape, first_batch[1].shape)

        def put(item) -> bool:
            while prob_ref() is not None:
                try:
                    q.put(item, timeout=1.0)
                    return True
                except queue.Full:
                    pass
            return False  # problem collected: stop producing

        if not put(first_batch):
            return
        it = first_iter  # continue past the peeked batch, then re-epoch
        while True:
            delivered = False
            for batch in it:
                x = np.asarray(batch[0])
                y = np.asarray(batch[1])
                if (x.shape, y.shape) != shapes:  # ragged final batch: skip
                    continue
                if not put((x, y)):
                    return
                delivered = True
            new_it = iter(source)
            if new_it is it or not delivered:
                # A one-shot iterator (iter() returned the exhausted
                # iterator itself, e.g. a plain generator) or an epoch with
                # no usable batch: a clear error instead of blocking the
                # evaluation forever.
                put((
                    "__stream_error__",
                    "data_source exhausted and not re-iterable (pass a re-iterable like a "
                    "list, Dataset or DataLoader, not a one-shot generator), or it yielded no "
                    f"batch matching the first batch's shapes {shapes}",
                ))
                return
            it = new_it

    def _host_next(self) -> tuple[np.ndarray, np.ndarray]:
        if not self._producer_started:
            self._producer_started = True
            threading.Thread(
                target=self._producer,
                args=(weakref.ref(self), self._queue, self._source, self._first_iter, self._first_batch),
                daemon=True,
            ).start()
        item = self._queue.get()
        if isinstance(item[0], str):  # ("__stream_error__", message)
            raise RuntimeError(item[1])
        x, y = item
        dx, dy = self._batch_dtypes
        return x.astype(dx, copy=False), y.astype(dy, copy=False)

    # -------------------------------------------------------------------

    def setup(self, key: torch.Tensor) -> State:
        del key
        return State(batch_cursor=torch.zeros((), dtype=torch.int32, device=self.device))

    def _reduce(self, losses: torch.Tensor) -> torch.Tensor:
        return torch.mean(losses) if self.reduction == "mean" else torch.sum(losses)

    def _population_loss(self, pop_params: Any, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
        """Each model's reduced loss over the (n_batches, batch, ...) batches
        ``xs``/``ys``, which every model shares."""

        def one_model_loss(params):
            losses = torch.func.vmap(lambda x, y: self.criterion_value(self.apply_fn(params, x), y))(xs, ys)
            return self._reduce(losses)

        return torch.func.vmap(one_model_loss)(pop_params)

    def evaluate(self, state: State, pop_params: Any) -> tuple[torch.Tensor, State]:
        if self.streaming:
            return self._evaluate_streaming(state, pop_params)
        cursor = state.batch_cursor
        # Row indices of this evaluation's batches, (n_batch_per_eval,
        # batch_size): device arithmetic on the cursor, no host read.
        batch = (cursor.to(torch.int64) + torch.arange(self.n_batch_per_eval, device=cursor.device)) % self.num_batches
        rows = batch[:, None] * self.batch_size + torch.arange(self.batch_size, device=cursor.device)
        fitness = self._population_loss(pop_params, self.inputs[rows], self.labels[rows])
        return fitness, state.replace(batch_cursor=(cursor + self.n_batch_per_eval) % self.num_batches)

    def _evaluate_streaming(self, state: State, pop_params: Any) -> tuple[torch.Tensor, State]:
        # This evaluation's batches, pulled ONCE in source order and shared
        # by the whole population.
        if self.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise NotImplementedError(
                "SupervisedLearningProblem(data_source=...) inside a CUDA graph capture: a graph "
                "cannot pull host batches (step the workflow eagerly)"
            )
        batches = [self._host_next() for _ in range(self.n_batch_per_eval)]
        xs = torch.from_numpy(np.stack([b[0] for b in batches])).to(self.device)
        ys = torch.from_numpy(np.stack([b[1] for b in batches])).to(self.device)
        fitness = self._population_loss(pop_params, xs, ys)
        return fitness, state.replace(batch_cursor=state.batch_cursor + 1)

    def criterion_value(self, pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        """Apply ``criterion`` and reduce non-scalar outputs per
        ``reduction``."""
        out = self.criterion(pred, label)
        if out.ndim > 0:
            out = self._reduce(out)
        return out
