"""The ``vdvae`` family (``models/vdvae.py``) on the CPU at a tiny size:
width 16, zdim 4, short block strings with mixins, 8×8 images.

* the port's model against the benchmark's plain reference
  (``benchmark/reference/vdvae.py``) on seeded random weights with the
  prior's last conv non-zero and injected noise: per-layer KLs,
  distortion, loss and every gradient;
* PixelCNN++'s coupled mixture at the edge bins and at the 1e-5 fallback,
  against a float64 golden written from the formula;
* the learned-prior KL op (``ops.reparam_prior_kl``): its plain path, its
  noise stream, its rule and its autograd.Function rehearsed with plain
  stand-ins;
* ``SkippingAdamW`` against ``torch.optim.AdamW``, and its skip;
* the family through ``make_train_fns`` and ``train_loop``: a skipped
  step leaves the state bit for bit, exact resume, validation;
* the entry points that do not serve the family raise.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from apv_tpu_torch import ops
from apv_tpu_torch.core.distributions import pixelcnn_mixture_logpmf
from apv_tpu_torch.models.vdvae import VDVAE, parse_blocks, prepare
from apv_tpu_torch.ops import dispatch
from apv_tpu_torch.ops import kernels as K
from apv_tpu_torch.training.optim import SkippingAdamW, constant
from apv_tpu_torch.utils.config import apply_overrides, get_preset

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import vdvae as R  # noqa: E402
from benchmark.reference.models import Precision  # noqa: E402

TINY = {"widths": [16], "z_dim": 4, "bottleneck_multiple": 0.25,
        "enc_blocks": "8x1,8d2,4x1,4d4,1x1",
        "dec_blocks": "1x1,4m1,4x1,8m4,8x1", "image_shape": [8, 8, 3],
        "mix_components": 2}
TINY_SETS = ["model.widths=[16]", "model.z_dim=4",
             f"model.enc_blocks={TINY['enc_blocks']}",
             f"model.dec_blocks={TINY['dec_blocks']}",
             "model.image_shape=[8,8,3]", "model.mix_components=2",
             "train.batch_size=4", "train.steps_per_call=2",
             "train.log_every=2", "train.checkpoint_every=4",
             "train.ema_decay=0.9"]


def tiny_model(dtype=torch.float32, seed=0) -> VDVAE:
    m = VDVAE(width=16, zdim=4, enc_blocks=TINY["enc_blocks"],
              dec_blocks=TINY["dec_blocks"], mixtures=2,
              image_shape=(8, 8, 3), dtype=dtype).init_(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():      # seeded random weights, none zero
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=gen)
                    * (0.3 if p.dim() > 1 else 0.1))
    return m.to(memory_format=torch.channels_last)


def tiny_batch(b=3, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, (b, 8, 8, 3), generator=gen,
                      dtype=torch.uint8)
    eps = [torch.randn(b, 4, r, r, generator=gen) for r in (1, 4, 4, 8, 8)]
    return x, eps


def tiny_cfg(tmp_path, *extra):
    return apply_overrides(get_preset("vdvae_cifar10"),
                           TINY_SETS + [f"results_dir={tmp_path}", *extra])


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

def test_parse_blocks_and_published_sizes():
    assert parse_blocks("1x1,4m1,4x2,8d2,16") == [
        (1, None), (4, 1), (4, None), (4, None), (8, 2), (16, None)]
    cfg = get_preset("vdvae_cifar10").model
    assert len(parse_blocks(cfg.enc_blocks)) == 33
    assert len(parse_blocks(cfg.dec_blocks)) == 43
    with torch.device("meta"):
        m = VDVAE(width=cfg.widths[0], zdim=cfg.z_dim,
                  enc_blocks=cfg.enc_blocks, dec_blocks=cfg.dec_blocks,
                  mixtures=cfg.mix_components)
    assert sum(p.numel() for p in m.parameters()) == 39_145_700


def _ref_of(port: VDVAE, prec=Precision()):
    ref = R.VDVAE(TINY, prec)
    ref.load_state_dict({k: v.clone().contiguous()
                         for k, v in port.state_dict().items()})
    return ref


def test_float32_model_matches_the_reference_values_and_gradients():
    """At float32 the port computes the reference's function: the two
    differ by the order of float32 sums alone (conv algorithms, the KL's
    reduction), so 1e-5 of each output's scale, and 1e-4 of each leaf
    gradient's norm (a gradient sums ~10³ products of such terms)."""
    port = tiny_model()
    ref = _ref_of(port)
    x, eps = tiny_batch()
    x_in, x_t = prepare(x)
    d, kls = port(x_in, x_t, eps=eps)
    kls = torch.stack(kls)
    dr, klr = ref(x_in, x_t, eps)
    assert kls.shape == klr.shape == (5, 3)
    torch.testing.assert_close(d, dr, rtol=1e-5,
                               atol=1e-5 * float(dr.detach().abs().max()))
    torch.testing.assert_close(kls, klr, rtol=1e-5,
                               atol=1e-5 * float(klr.detach().abs().max()))
    assert (klr.abs() > 1e-3).all()         # the prior's conv is non-zero
    loss = (d + kls.sum(0)).mean() / 192
    loss_r = (dr + klr.sum(0)).mean() / 192
    gp = torch.autograd.grad(loss, list(port.parameters()))
    gr = dict(zip([n for n, _ in ref.named_parameters()],
                  torch.autograd.grad(loss_r, list(ref.parameters()))))
    for (name, _), a in zip(port.named_parameters(), gp):
        b = gr[name]
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-7, name


def test_bfloat16_model_tracks_the_reference():
    """In bfloat16 (the configuration's convs and residual state) the
    distortion and loss stay within 1% of the float32 reference: bf16
    carries 8 bits, and the distortion averages 192 terms of one sign."""
    port = tiny_model(torch.bfloat16)
    ref = _ref_of(port)
    x, eps = tiny_batch()
    x_in, x_t = prepare(x)
    d, kls = port(x_in, x_t, eps=eps)
    dr, klr = ref(x_in, x_t, eps)
    assert d.dtype == torch.float32 and kls[0].dtype == torch.float32
    torch.testing.assert_close(d, dr, rtol=1e-2, atol=0.0)
    total = (d + torch.stack(kls).sum(0)).mean()
    total_r = (dr + klr.sum(0)).mean()
    assert abs(float(total - total_r)) <= 1e-2 * abs(float(total_r))


def test_published_init_structure():
    m = VDVAE(width=16, zdim=4, enc_blocks=TINY["enc_blocks"],
              dec_blocks=TINY["dec_blocks"], mixtures=2,
              image_shape=(8, 8, 3)).init_(3)
    again = VDVAE(width=16, zdim=4, enc_blocks=TINY["enc_blocks"],
                  dec_blocks=TINY["dec_blocks"], mixtures=2,
                  image_shape=(8, 8, 3)).init_(3)
    for a, b in zip(m.parameters(), again.parameters()):
        assert torch.equal(a, b)
    for b in m.decoder.dec_blocks:
        assert not b.prior.c4.weight.any() and not b.prior.c4.bias.any()
        # z_proj: U(±1/√fan_in)·√(1/n), n = 5 decoder blocks
        bound = 1.0 / math.sqrt(4) * math.sqrt(1 / 5)
        assert float(b.z_proj.weight.abs().max()) <= bound
    c4 = m.encoder.enc_blocks[0].c4.weight
    assert float(c4.abs().max()) <= 1.0 / math.sqrt(4) * math.sqrt(1 / 5)
    assert not m.encoder.in_conv.bias.any()
    assert torch.equal(m.decoder.gain, torch.ones_like(m.decoder.gain))


# ---------------------------------------------------------------------------
# the coupled mixture
# ---------------------------------------------------------------------------

def _sigmoid(v):
    return 0.5 * (1.0 + np.tanh(0.5 * v))


def _golden(x, mean, log_s):
    """One logistic (K = 1, coefficients 0), float64, from the formula."""
    inv = np.exp(-log_s)
    c = x - mean
    if x < -0.999:
        return np.log(_sigmoid(inv * (c + 1 / 255)))
    if x > 0.999:
        return np.log(1.0 - _sigmoid(inv * (c - 1 / 255)))
    delta = _sigmoid(inv * (c + 1 / 255)) - _sigmoid(inv * (c - 1 / 255))
    if delta > 1e-5:
        return np.log(delta)
    mid = inv * c
    return mid - log_s - 2.0 * np.log1p(np.exp(mid)) - np.log(127.5)


@pytest.mark.parametrize("level,mean,log_s", [
    (0, -0.9, -3.0),        # the left edge bin: the left tail
    (255, 0.95, -2.5),      # the right edge bin: the right tail
    (128, 0.0, -2.0),       # an interior bin of fair mass
    (60, 0.8, -6.5),        # far from a narrow mean: mass under 1e-5
    (200, 0.2, -9.0),       # log-scale under the floor of −7
])
def test_mixture_edge_bins_and_fallback(level, mean, log_s):
    v = (level - 127.5) / 127.5
    # the mixture logit, then per channel [mean, log_scale, coefficient]
    l = torch.zeros(1, 1, 1, 10)
    for ch in range(3):
        l[..., 1 + 3 * ch] = mean
        l[..., 2 + 3 * ch] = log_s
    x = torch.full((1, 1, 1, 3), v)
    got = float(pixelcnn_mixture_logpmf(x, l))
    want = 3 * _golden(v, mean, max(log_s, -7.0))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-5)
    assert got == pytest.approx(float(R.mixture_logpmf(x, l)), rel=1e-6,
                                abs=1e-6)


def test_mixture_coupling_and_weights_against_the_reference():
    gen = torch.Generator().manual_seed(5)
    l = torch.randn(2, 4, 4, 100, generator=gen)
    x = (torch.randint(0, 256, (2, 4, 4, 3), generator=gen).float()
         - 127.5) / 127.5
    got = pixelcnn_mixture_logpmf(x, l)
    torch.testing.assert_close(got, R.mixture_logpmf(x, l), rtol=1e-6,
                               atol=1e-4)
    # channel 0's coefficient slots couple x_R into G's mean
    l2 = l.clone()
    l2[..., 10 + 20:10 + 30] += 1.0
    assert not torch.allclose(pixelcnn_mixture_logpmf(x, l2), got)


# ---------------------------------------------------------------------------
# the learned-prior KL op
# ---------------------------------------------------------------------------

def _qp(b=3, z=4, r=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q = (0.5 * torch.randn(b, 2 * z, r, r, generator=gen)).contiguous(
        memory_format=torch.channels_last)
    p = (0.5 * torch.randn(b, 2 * z, r, r, generator=gen)).contiguous(
        memory_format=torch.channels_last)
    return q, p


def test_prior_kl_values_against_torch_distributions():
    q, p = _qp()
    eps = torch.randn(3, 4, 2, 2, generator=torch.Generator().manual_seed(1))
    z, kl = ops.reparam_prior_kl(q, p, eps=eps)
    qm, qs, pm, ps = q[:, :4], q[:, 4:], p[:, :4], p[:, 4:]
    torch.testing.assert_close(z, qm + qs.exp() * eps)
    want = torch.distributions.kl_divergence(
        torch.distributions.Normal(qm.double(), qs.double().exp()),
        torch.distributions.Normal(pm.double(), ps.double().exp())
    ).sum(dim=(1, 2, 3))
    torch.testing.assert_close(kl.double(), want, rtol=1e-5, atol=1e-5)


def test_prior_noise_stream_is_reparam_samples_in_channels_last_order():
    q, p = _qp(b=2, z=4, r=3)
    gen = torch.Generator().manual_seed(7)
    seed, offset = K.draw_key(torch.Generator().manual_seed(7))
    z, _ = ops.reparam_prior_kl(q, p, generator=gen)
    flat = K.philox_normals(2 * 4 * 9, seed, offset)
    eps = flat.reshape(2, 3, 3, 4).permute(0, 3, 1, 2)
    torch.testing.assert_close(z, q[:, :4] + q[:, 4:].exp() * eps)


def test_prior_kl_rule_matches_autograd():
    q, p = _qp(seed=2)
    q.requires_grad_(True)
    p.requires_grad_(True)
    eps = torch.randn(3, 4, 2, 2, generator=torch.Generator().manual_seed(3))
    z, kl = ops.reparam_prior_kl(q, p, eps=eps)
    g = torch.randn_like(z)
    g_kl = torch.randn(3)
    dq, dp = torch.autograd.grad((z * g).sum() + (kl * g_kl).sum(), (q, p),
                                 retain_graph=True)
    rq, rp = K.reparam_prior_bwd_plain(g, z.detach(), q.detach(),
                                       p.detach(), g_kl)
    torch.testing.assert_close(rq, dq, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rp, dp, rtol=1e-5, atol=1e-6)
    # each output alone
    for gz, gk in ((g, None), (None, g_kl)):
        loss = ((z * gz).sum() if gz is not None else 0.0) + (
            (kl * gk).sum() if gk is not None else 0.0)
        aq, ap = torch.autograd.grad(loss, (q, p), retain_graph=True,
                                     allow_unused=True)
        ap = torch.zeros_like(p) if ap is None else ap
        bq, bp = K.reparam_prior_bwd_plain(gz, z.detach(), q.detach(),
                                           p.detach(), gk)
        torch.testing.assert_close(bq, aq, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(bp, ap, rtol=1e-5, atol=1e-6)


def test_prior_kl_function_rehearsed_with_plain_stand_ins(monkeypatch):
    """The CUDA path's autograd.Function on CPU tensors, the kernels'
    wrappers replaced by the plain versions: one launch each way, the
    plain path's values and gradients, None for an output without one."""
    calls = []

    def fwd(q, p, seed, offset):
        calls.append("reparam")
        return K.reparam_prior_plain(q, p, seed, offset)

    def bwd(g, z, q, p, g_kl):
        calls.append(("reparam_bwd", g is None, g_kl is None))
        return K.reparam_prior_bwd_plain(g, z, q, p, g_kl)

    monkeypatch.setattr(K, "reparam_prior_cuda", fwd)
    monkeypatch.setattr(K, "reparam_prior_bwd_cuda", bwd)
    q, p = _qp(seed=4)
    q.requires_grad_(True)
    p.requires_grad_(True)
    z, kl = dispatch._PriorPosteriorFn.apply(q, p, 11, 22)
    zr, klr = K.reparam_prior_plain(q, p, 11, 22)
    torch.testing.assert_close(z, zr)
    torch.testing.assert_close(kl, klr)
    dq, dp = torch.autograd.grad(kl.sum(), (q, p))
    rq, rp = torch.autograd.grad(klr.sum(), (q, p))
    torch.testing.assert_close(dq, rq, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dp, rp, rtol=1e-5, atol=1e-6)
    assert calls == ["reparam", ("reparam_bwd", True, False)]


def test_prior_kl_refusals():
    q, p = _qp()
    with pytest.raises(ValueError, match="alike"):
        ops.reparam_prior_kl(q, p[:, :6])
    with pytest.raises(ValueError, match="eps has shape"):
        ops.reparam_prior_kl(q, p, eps=torch.zeros(3, 4, 2, 1))
    with pytest.raises(ValueError, match="CUDA kernel"):
        K.reparam_prior_cuda(q, p, 1, 2)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def _pair(seed=0):
    gen = torch.Generator().manual_seed(seed)
    ps = [torch.randn(5, 3, generator=gen), torch.randn(7, generator=gen),
          torch.randn(2, 3, 1, 1, generator=gen).contiguous(
              memory_format=torch.channels_last)]
    return ps, [p.clone().requires_grad_(True) for p in ps], gen


def test_skipping_adamw_matches_torch_adamw_out_of_the_clip():
    ps, ref, gen = _pair()
    sched = [0.0, 5e-3, 1e-2, 1e-2, 1e-2, 1e-2]
    opt = SkippingAdamW(ps, lambda c: sched[c], clip_norm=1e9,
                        skip_threshold=1e9, weight_decay=0.01, b2=0.9)
    topt = torch.optim.AdamW(ref, lr=0.0, betas=(0.9, 0.9),
                             weight_decay=0.01, foreach=False)
    for i in range(6):
        g = [torch.randn(p.shape, generator=gen) for p in ps]
        opt.step([x.clone() for x in g])
        for r, x in zip(ref, g):
            r.grad = x.clone()
        topt.param_groups[0]["lr"] = sched[i]
        topt.step()
    for a, b in zip(ps, ref):
        torch.testing.assert_close(a, b.detach(), rtol=1e-6, atol=1e-7)
    assert opt.count == 6 and float(opt.applied) == 6.0
    assert float(opt.skipped) == 0.0


def test_skipping_adamw_clips_by_the_global_norm():
    ps, _, gen = _pair(1)
    g = [10 * torch.randn(p.shape, generator=gen) for p in ps]
    norm = float(torch.sqrt(sum((x.double() ** 2).sum() for x in g)))
    a = SkippingAdamW([p.clone() for p in ps], constant(1e-2), clip_norm=1.0,
                      skip_threshold=1e9, weight_decay=0.0)
    b = SkippingAdamW([p.clone() for p in ps], constant(1e-2), clip_norm=1e9,
                      skip_threshold=1e9, weight_decay=0.0)
    got = a.step([x.clone() for x in g])
    b.step([x * (1.0 / (norm + 1e-6)) for x in g])
    assert float(got) == pytest.approx(norm, rel=1e-5)
    for x, y in zip(a.mu, b.mu):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("why", ["norm", "nan_term", "nan_grad"])
def test_skipped_update_leaves_everything(why):
    ps, _, gen = _pair(2)
    opt = SkippingAdamW(ps, constant(1e-2), clip_norm=1.0,
                        skip_threshold=1e9, weight_decay=0.01)
    ema = [p.clone() for p in ps]
    for _ in range(2):
        opt.step([torch.randn(p.shape, generator=gen) for p in ps])
        opt.ema_(ema, 0.9)
    saved = [t.clone() for t in ps + opt.mu + opt.nu + ema]
    applied = float(opt.applied)
    g = [torch.randn(p.shape, generator=gen) for p in ps]
    terms = ()
    if why == "norm":
        opt.skip_threshold = 1e-3
    elif why == "nan_term":
        terms = (torch.tensor(float("nan")),)
    else:
        g[0][0, 0] = float("nan")
    opt.step(g, terms)
    opt.ema_(ema, 0.9)
    after = ps + opt.mu + opt.nu + ema
    assert all(torch.equal(a, b) for a, b in zip(saved, after))
    assert float(opt.applied) == applied and float(opt.skipped) == 1.0
    assert opt.count == 3                  # the schedule's iterations


# ---------------------------------------------------------------------------
# the family through the step and the loop
# ---------------------------------------------------------------------------

def _state_tensors(state):
    return [t.detach().clone() for t in state.tensors()]


def test_train_step_skip_is_bit_exact(tmp_path):
    from apv_tpu_torch.training.step import make_train_fns
    fns = make_train_fns(tiny_cfg(tmp_path), device="cpu")
    state = fns.init_fn(0)
    state.opt.skip_threshold = 1e-12
    x, _ = tiny_batch(4)

    def kept():          # all of the state but the count of skipped updates
        return [t.detach().clone() for t in state.tensors()
                if t is not state.opt.skipped]

    before = kept()
    state, m = fns.train_step(state, {"image": x})
    assert all(torch.equal(a, b) for a, b in zip(before, kept()))
    assert float(m["skipped_updates"]) == 1.0 and state.step == 1
    assert float(state.opt.skipped) == 1.0 and state.opt.count == 1
    assert len(m["kl_layers"]) == 5 and float(m["grad_norm"]) > 0.0


def test_train_step_matches_the_reference_update(tmp_path):
    """One float32 step of the port's training path against the
    reference's published update from the same weights, batch and noise
    (the layers' keys drawn in order from the step's generator)."""
    from apv_tpu_torch.training.step import make_train_fns
    cfg = tiny_cfg(tmp_path, "train.lr_warmup_steps=1")
    fns = make_train_fns(cfg, device="cpu", dtype=torch.float32)
    state = fns.init_fn(0)
    w = {k: v.clone() for k, v in state.model.state_dict().items()}
    images = torch.randint(0, 256, (12, 8, 8, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    from benchmark.reference.train import batch_rows
    state.step = 3                     # AdamW's counts at 3, moments zero
    state.opt.load_state_dict({"count": 3, "mu": state.opt.mu,
                               "nu": state.opt.nu})
    rows = torch.from_numpy(batch_rows(12, 4, state.seed, 3))
    state, m = fns.train_step(state, {"image": images[rows]})
    tree = dataclasses.asdict(cfg)
    ref = R.follow(tree, {k: v.contiguous() for k, v in w.items()}, images,
                   1, state.seed, start=3)
    assert m["loss"].item() == pytest.approx(ref["loss"][0], rel=1e-5)
    np.testing.assert_allclose(m["kl_layers"].numpy(), ref["kl_layers"][0],
                               rtol=1e-4, atol=1e-6)
    for name, p in state.model.named_parameters():
        torch.testing.assert_close(p.detach(), ref["params"][name],
                                   rtol=1e-4, atol=1e-6)
    for e, (name, _) in zip(state.ema_model.parameters(),
                            state.model.named_parameters()):
        torch.testing.assert_close(e, ref["ema"][name], rtol=1e-4,
                                   atol=1e-6)


def test_loop_resume_is_exact_and_validates(tmp_path):
    from apv_tpu_torch.training.loop import train_loop
    images = np.random.default_rng(0).integers(0, 256, (40, 8, 8, 3),
                                               dtype=np.uint8)
    straight = train_loop(tiny_cfg(tmp_path / "a"), max_steps=8,
                          arrays={"image": images}, device="cpu")
    cfg = tiny_cfg(tmp_path / "b")
    train_loop(cfg, max_steps=4, arrays={"image": images}, device="cpu")
    resumed = train_loop(cfg, max_steps=4, arrays={"image": images},
                         resume=True, device="cpu")
    assert resumed.step == straight.step == 8
    for a, b in zip(_state_tensors(straight), _state_tensors(resumed)):
        assert torch.equal(a, b)
    assert resumed.opt.count == 8 and float(resumed.opt.applied) == 8.0
    recs = [json.loads(x) for x in
            (tmp_path / "b" / cfg.name / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in recs] == [0, 2, 4, 6]
    assert all(len(r["kl_layers"]) == 5 and r["skipped_updates"] == 0.0
               for r in recs)
    # the validation ELBO of the family
    from apv_tpu_torch.training.step import make_train_fns
    fns = make_train_fns(cfg, device="cpu")
    vm = fns.eval_step(resumed, {"image": torch.from_numpy(images[:4])})
    assert set(vm) == {"valid_elbo", "valid_recon", "valid_kl"}
    assert float(vm["valid_elbo"]) == pytest.approx(
        float(vm["valid_recon"] - vm["valid_kl"]), rel=1e-6)


def test_family_refusals(tmp_path):
    from apv_tpu_torch import api
    from apv_tpu_torch.eval.run import evaluate_nll
    from apv_tpu_torch.training.step import make_train_fns
    for fn in (api.evaluate, api.sample, api.visualize, api.ood_score,
               api.export_artifact):
        with pytest.raises(NotImplementedError, match="'vdvae' family"):
            fn("vdvae_cifar10", device="cpu")
    cfg = tiny_cfg(tmp_path)
    with pytest.raises(NotImplementedError, match="'vdvae' family"):
        evaluate_nll(cfg, None, None, np.zeros((1, 8, 8, 3), np.uint8),
                     device="cpu")
    with pytest.raises(ValueError, match="vdvae family"):
        make_train_fns(apply_overrides(cfg, ["adversarial.enabled=true"]),
                       device="cpu")
    with pytest.raises(ValueError, match="no gradient accumulation"):
        make_train_fns(apply_overrides(cfg, ["train.grad_accum=2"]),
                       device="cpu")
