"""A whole run of each cell at a small size on the CPU (the look for a card
skipped, ``device='cpu'``), sound and then with the timed path broken
underneath: the sound run is correct, each planted fault is not.

The faults a cell can have: a step that returns its state unchanged; half
of the batch left out, the mean taken over the rest; for the scoring
cells, an answer (a score) altered where it is produced; and for the
training cell, G's gradient without the KL's or without D(z)'s, their
values left in the loss. A training cell's answer is its state, which
these reach; its losses are printed, not compared. No cell runs on more than one card, so none has an
exchange between cards to leave out.
The limits here are for this size, set from its sound readings as the
cells' are from theirs (``conftest.py``'s shapes; ``PERF.md``).
"""

from __future__ import annotations

import pytest
from conftest import CELLS, TINY, TINY_WORK

from benchmark import run as harness

LIMITS = {CELLS[0]: {"grad_gap": 0.02, "change_gap": 0.05, "kl_gap": 0.05,
                     "adv_gap": 0.15, "d_loss_gap": 0.05},
          CELLS[1]: {"score_gap": 4.0, "log_z_gap": 1e-5},
          CELLS[2]: {"score_gap": 4.0, "log_z_gap": 1e-5}}
KIND = {CELLS[0]: "train_loop", CELLS[1]: "evaluate_nll",
        CELLS[2]: "evaluate_nll"}
# The training cell a little wider than TINY, so that the KL (z 64) and
# D(z) weigh in G's gradient as they do at the cell's size and their
# faults read above rounding.
WIDER = {"train_loop": {"model": {"z_dim": 64, "widths": [16, 32],
                                  "dense": 64},
                        "adversarial": {"d_widths": [64, 64]}},
         "evaluate_nll": {}}


def run_tiny(cell: str, seed: int = 2 ** 31 + 77) -> dict:
    kind = KIND[cell]
    return harness.run_cell(cell, seed, 0.3, False, device="cpu",
                            config_overrides=harness._merge(TINY,
                                                            WIDER[kind]),
                            workload_overrides={**TINY_WORK[kind],
                                                "limits": LIMITS[cell]})


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = run_tiny(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


def _state_unchanged(monkeypatch, kind):
    if kind == "train_loop":
        from apv_tpu_torch.training import optim

        def no_update(self, grads, norm, scales):
            self.count += 1                  # counts, moves nothing
        monkeypatch.setattr(optim.ClippedAdam, "_apply", no_update)
    else:
        from apv_tpu_torch.core import iwae
        monkeypatch.setattr(iwae, "streaming_logsumexp_update",
                            lambda state, logw: state)


def _half_batch(monkeypatch, kind):
    if kind == "train_loop":
        from apv_tpu_torch.training import step
        real = step.prepare_batch

        def half(cfg, batch, draw_u=None, u=None):
            x_in, x_target = real(cfg, batch, draw_u, u)
            n = x_in.shape[0] // 2
            return x_in[:n], x_target[:n]
        monkeypatch.setattr(step, "prepare_batch", half)
    else:
        from apv_tpu_torch.eval import run
        real = run._batches

        def half(*args, **kw):
            for x_in, x_target in real(*args, **kw):
                n = x_in.shape[0] // 2
                yield x_in[:n], x_target[:n]
        monkeypatch.setattr(run, "_batches", half)


def _kl_grad_dropped(monkeypatch, kind):
    import apv_tpu_torch.ops as ops
    real = ops.reparam_kl

    def no_kl_grad(*args, **kw):      # the KL's value kept, its gradient not
        z, kl = real(*args, **kw)
        return z, kl.detach()
    monkeypatch.setattr(ops, "reparam_kl", no_kl_grad)


def _adv_grad_dropped(monkeypatch, kind):
    from apv_tpu_torch.training import losses
    real = losses.generator_adv_term

    def no_adv_grad(d_logits, variant):   # G's D(z) term, no gradient
        return real(d_logits, variant).detach()
    monkeypatch.setattr(losses, "generator_adv_term", no_adv_grad)


def _answer_altered(monkeypatch, kind):
    from apv_tpu_torch.eval import run
    real = run._grid_scores

    def rolled(*args, **kw):          # each image gets its neighbour's
        return real(*args, **kw).roll(1)
    monkeypatch.setattr(run, "_grid_scores", rolled)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered,
          "kl_grad_dropped": _kl_grad_dropped,
          "adv_grad_dropped": _adv_grad_dropped}
# a training cell's answer is its state; the gradient faults are G's
ONLY = {"answer_altered": "evaluate_nll", "kl_grad_dropped": "train_loop",
        "adv_grad_dropped": "train_loop"}
CASES = [(cell, fault) for cell in CELLS for fault in sorted(FAULTS)
         if ONLY.get(fault, KIND[cell]) == KIND[cell]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_planted_fault_is_not_correct(monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch, KIND[cell])
    r = run_tiny(cell)
    assert not r["correct"], r["checks"]
