"""The train step captured in a CUDA graph and replayed: the counterpart of
the reference's jitted step, scanned over ``steps_per_call`` steps in one
XLA program (``apv_tpu/training/step.py``, ``multi_step``).

Run eagerly, a step of the port is several hundred kernel launches from
Python, and the host, not the card, sets the pace. ``StepRunner`` runs a
``train_loop`` invocation's steps: the first eagerly (it is also the
warm-up of cuBLAS's and cuDNN's lazy state), the second captured into one
``torch.cuda.CUDAGraph`` on a side stream, and that and every later step
by replaying the graph. A replay launches the step's kernels as the eager
step does: the same hand-written kernels, cuDNN's convolutions and the
optimizers' foreach and fused kernels, in the same order.

What a graph would freeze is read from the device instead: the step's
``run`` (``training/step.py``) reads every host number that changes from
step to step from its inputs, which ``draw`` writes in place before each
replay (the device draws, and the block of keys, β and the optimizers'
learning rates and bias corrections), with the batch copied into the
graph's static batch on the stream. The host's counts that ``run``
advances (the state's step, the optimizers' counts) and the kernel
wrappers' launch and route counters (``ops.kernels.COUNTERS``) are
advanced on each replay by what the capture counted; the metrics, static
tensors that the next replay overwrites, are handed out as a copy (one
copy a dtype, no read-back).

When: on a CUDA device without a process group (gloo's collectives
cannot be captured) and with ``train.grad_accum == 1`` (an accumulating
optimizer branches on its host micro-step); everywhere else, the CPU
included, every step runs eagerly. The graph's private memory pool is
released when the invocation ends (``close``). While the step is
captured the span recorder records nothing inside it
(``utils/logging.py``); it counts the captures and the replayed steps.
"""

from __future__ import annotations

import torch

from apv_tpu_torch.ops import kernels as K
from apv_tpu_torch.parallel import multihost
from apv_tpu_torch.training.state import TrainState
from apv_tpu_torch.training.step import TrainFns
from apv_tpu_torch.utils.config import Config
from apv_tpu_torch.utils.logging import RECORDER


def capturable(cfg: Config, device: torch.device) -> bool:
    """Whether ``train_loop`` replays its steps from a captured graph."""
    return (torch.device(device).type == "cuda" and not multihost.active()
            and cfg.train.grad_accum == 1)


def _host_counts(state: TrainState) -> list[tuple[object, str]]:
    """The host numbers a step advances: (object, attribute)."""
    return [(state, "step")] + [(opt, "count") for opt in (state.opt,
                                                           state.d_opt)
                                if opt is not None]


def new_graph():
    """A CUDA graph and the context that captures into it."""
    g = torch.cuda.CUDAGraph()
    return g, torch.cuda.graph(g)


class StepRunner:
    """Runs a ``train_loop`` invocation's steps, ``(state, batch) ->
    (state, metrics)`` as ``fns.train_step``: eagerly, or with ``capture``
    from the second step on by replaying a captured one (module
    docstring)."""

    def __init__(self, fns: TrainFns, capture: bool):
        self.fns, self.capture = fns, capture
        self.eager = 0               # steps run eagerly
        self.graph = None

    def __call__(self, state: TrainState, batch: dict):
        if not self.capture or (self.graph is None and self.eager == 0):
            self.eager += 1
            return self.fns.train_step(state, batch)
        if self.graph is None:
            self._capture(state, batch)
        return self._replay(state, batch)

    def _capture(self, state: TrainState, batch: dict) -> None:
        """Capture ``run`` on static inputs; the host's counts are left as
        they were (the capture executes nothing)."""
        self.batch = {k: torch.empty_like(v) for k, v in batch.items()}
        self.inputs = self.fns.draw(state, self.batch)
        counts = _host_counts(state)
        before = [getattr(o, a) for o, a in counts]
        launched = [dict(c) for c in K.COUNTERS]
        graph, capturing = new_graph()
        with RECORDER.quiet(), capturing:
            _, metrics = self.fns.run(state, self.batch, self.inputs)
            groups: dict = {}
            for name, v in metrics.items():
                if not torch.is_tensor(v):
                    raise TypeError(f"a captured step's metric {name!r} is "
                                    f"{type(v).__name__}, not a tensor: a "
                                    "replay would repeat its capture's value")
                groups.setdefault(v.dtype, []).append(name)
            flat = {dt: torch.cat([metrics[n].reshape(-1) for n in names])
                    for dt, names in groups.items()}
        self.advance = []
        for (o, a), b in zip(counts, before):
            self.advance.append(getattr(o, a) - b)
            setattr(o, a, b)
        self.launched = []
        for c, b in zip(K.COUNTERS, launched):
            self.launched.append({n: c[n] - b.get(n, 0) for n in c})
            c.clear()
            c.update(b)
        self.layout = [(name, dt, metrics[name].shape)
                       for dt, names in groups.items() for name in names]
        self.graph, self.flat = graph, flat
        RECORDER.count("captures")

    def _replay(self, state: TrainState, batch: dict):
        for k, v in batch.items():
            s = self.batch[k]
            if v.shape != s.shape or v.dtype != s.dtype:
                raise ValueError(f"a replayed step's batch {k!r} is "
                                 f"{v.dtype} {tuple(v.shape)}; the graph "
                                 f"was captured at {s.dtype} "
                                 f"{tuple(s.shape)}")
        self.fns.draw(state, self.batch, out=self.inputs)
        for k, v in batch.items():
            self.batch[k].copy_(v)
        self.graph.replay()
        copies = {dt: t.clone() for dt, t in self.flat.items()}
        at = dict.fromkeys(copies, 0)
        metrics = {}
        for name, dt, shape in self.layout:
            n = shape.numel()
            metrics[name] = copies[dt][at[dt]:at[dt] + n].view(shape)
            at[dt] += n
        for (o, a), d in zip(_host_counts(state), self.advance):
            setattr(o, a, getattr(o, a) + d)
        for c, d in zip(K.COUNTERS, self.launched):
            for n, v in d.items():
                c[n] = c.get(n, 0) + v
        RECORDER.count("replayed_steps")
        return state, metrics

    def close(self) -> None:
        """Release the graph and its memory pool."""
        if self.graph is None:
            return
        self.graph.reset()
        self.graph = self.flat = self.inputs = self.batch = None
        torch.cuda.empty_cache()
