"""Hand-written CUDA kernels, their ctypes wrappers, launch counters and
plain PyTorch versions.

Each forward kernel replaces one Pallas TPU kernel of
``apv_tpu/ops/kernels.py`` and computes the same function (not the same
blocks); each backward kernel replaces the jnp rule of that op's
``custom_vjp``:

* ``bernoulli`` (``csrc/bernoulli.cu``) replaces ``_bernoulli_fwd`` /
  ``_bernoulli_kernel``. Bound: memory, 2 f32 reads per element (20.1 MB at
  the MNIST IWAE chunk [3200, 784]). Design: one warp per row, float4
  loads, warp-shuffle sum. ``bernoulli_bwd`` (same file) replaces
  ``_bernoulli_bwd``: elementwise, dx written only when asked for.
* ``disc_logistic`` (``csrc/disc_logistic.cu``) replaces
  ``_disc_logistic_fwd`` / ``_disc_logistic_kernel``. Bound: memory, 3 f32
  reads per element (59.0 MB at the IWAE chunk [1600, 3072]). Design: one
  256-thread block per row, float4 loads, register sums reduced by warp
  shuffles, [rows] written. ``disc_logistic_bwd`` (same file) replaces
  ``_disc_logistic_bwd``: elementwise in the same layout, bound by memory
  (15.7 MB at the train step's [256, 3072] without dx), dx written only
  when asked for.
* ``kl`` (``csrc/kl.cu``) replaces ``_kl_fwd`` / ``_kl_kernel``. Bound:
  launch latency (65.5 KB at [64, 128]). Design: one warp per row.
  ``kl_bwd`` (same file) replaces ``_kl_bwd``.
* ``reparam`` (``csrc/reparam.cu``) replaces ``_reparam_fwd`` /
  ``_reparam_kernel``. Bound: launch latency (0.82 MB written at
  [25, 64, 128]). Design: Philox4x32-10 + Box-Muller inside the kernel;
  mean and logvar are read as [B, Z] for all S samples. ``reparam_bwd``
  (same file) replaces ``_reparam_bwd`` + ``_unbroadcast``: one thread per
  element sums over the sample axis, deterministic, no atomics.

The wrappers (``*_cuda``) take CUDA tensors only: they check device, dtype,
shape and contiguity, allocate the outputs with ``torch.empty``, launch on
the current stream, raise on a nonzero ``cudaError_t``, and add one to
``launches[name]`` per launch. They record no gradient, so an input that
requires grad raises: the differentiable path is ``ops/dispatch.py``, whose
``torch.autograd.Function``s pair each forward kernel with its backward
kernel and hand both detached tensors.

The plain versions (``*_plain``) compute the same functions with torch
ops. The dispatch layer sends CPU tensors to the forward ones (autograd
differentiates them there); the backward ones write out the JAX rules and
serve the tests and ``chip_smoke.py``, which holds each kernel against its
plain version on the card.
"""

from __future__ import annotations

import torch

from apv_tpu_torch.core import distributions as D

# Launch count per kernel, incremented by the wrappers only.
launches: dict[str, int] = {
    "reparam": 0, "kl": 0, "disc_logistic": 0, "bernoulli": 0,
    "reparam_bwd": 0, "kl_bwd": 0, "bernoulli_bwd": 0,
    "disc_logistic_bwd": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# wrapper plumbing
# ---------------------------------------------------------------------------

def _check(name: str, *tensors: torch.Tensor) -> None:
    """Device, dtype, contiguity and no grad for all; equal shapes."""
    _check_each(name, *tensors)
    first = tensors[0]
    for t in tensors[1:]:
        if t.shape != first.shape or t.device != first.device:
            raise ValueError(f"{name}: inputs differ in shape or device: "
                             f"{tuple(first.shape)}@{first.device} vs "
                             f"{tuple(t.shape)}@{t.device}")


def _check_each(name: str, *tensors: torch.Tensor) -> None:
    if any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the raw CUDA wrapper is forward only and records no "
            "gradient; differentiate through apv_tpu_torch.ops (whose "
            "autograd.Function pairs it with its backward kernel), or call "
            "it under torch.inference_mode() or on detached tensors")
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: CUDA kernel got a tensor on "
                             f"{t.device}; the plain version takes CPU ones")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expects float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")


def _check_row_grad(name: str, g: torch.Tensor,
                    rows_like: torch.Tensor) -> None:
    """g is the [rows] incoming gradient of a per-row reduction."""
    _check_each(name, g)
    if g.shape != rows_like.shape[:1] or g.device != rows_like.device:
        raise ValueError(f"{name}: gradient {tuple(g.shape)}@{g.device} does "
                         f"not match rows {tuple(rows_like.shape[:1])}@"
                         f"{rows_like.device}")


def _rows_2d(name: str, t: torch.Tensor) -> tuple[int, int]:
    if t.dim() != 2:
        raise ValueError(f"{name}: expects [rows, E], got {tuple(t.shape)}")
    return t.shape[0], t.shape[1]


def _launch(name: str, fn, *args, device: torch.device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = fn(*args, stream)
    if status != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t "
                           f"{status}")
    launches[name] += 1


def _lib():
    from apv_tpu_torch.ops import _build
    return _build.library()


# ---------------------------------------------------------------------------
# bernoulli
# ---------------------------------------------------------------------------

def bernoulli_plain(x: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Per-row sum of x·l − softplus(l) -> [rows]."""
    ll = D.bernoulli_logpmf(x, logits)
    return ll.reshape(ll.shape[0], -1).sum(dim=-1)


def bernoulli_cuda(x: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Kernel version of ``bernoulli_plain`` on f32 [rows, E] inputs."""
    _check("bernoulli", x, logits)
    rows, event = _rows_2d("bernoulli", x)
    out = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows:
        _launch("bernoulli", _lib().apv_bernoulli, x.data_ptr(),
                logits.data_ptr(), out.data_ptr(), rows, event,
                device=x.device)
    return out


def _per_row(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return g.reshape((g.shape[0],) + (1,) * (like.dim() - 1))


def bernoulli_bwd_plain(g: torch.Tensor, x: torch.Tensor,
                        logits: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``_bernoulli_bwd``: (dx, dlogits) = (g·l, g·(x − σ(l))), g per row."""
    gb = _per_row(g, x)
    return gb * logits, gb * (x - torch.sigmoid(logits))


def bernoulli_bwd_cuda(g: torch.Tensor, x: torch.Tensor,
                       logits: torch.Tensor, *, want_dx: bool = True
                       ) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Kernel version of ``bernoulli_bwd_plain`` on f32 g [rows] and x,
    logits [rows, E]; dx is None unless ``want_dx``."""
    _check("bernoulli_bwd", x, logits)
    _check_row_grad("bernoulli_bwd", g, x)
    rows, event = _rows_2d("bernoulli_bwd", x)
    dl = torch.empty_like(logits)
    dx = torch.empty_like(x) if want_dx else None
    if rows:
        _launch("bernoulli_bwd", _lib().apv_bernoulli_bwd, g.data_ptr(),
                x.data_ptr(), logits.data_ptr(),
                None if dx is None else dx.data_ptr(), dl.data_ptr(), rows,
                event, device=x.device)
    return dx, dl


# ---------------------------------------------------------------------------
# disc_logistic
# ---------------------------------------------------------------------------

def disc_logistic_plain(x: torch.Tensor, mean: torch.Tensor,
                        log_scale: torch.Tensor,
                        bin_size: float = 1.0 / 255.0) -> torch.Tensor:
    """Per-row sum of the discretized-logistic log pmf -> [rows]."""
    ll = D.discretized_logistic_logpmf(x, mean, log_scale, bin_size=bin_size)
    return ll.reshape(ll.shape[0], -1).sum(dim=-1)


def disc_logistic_cuda(x: torch.Tensor, mean: torch.Tensor,
                       log_scale: torch.Tensor,
                       bin_size: float = 1.0 / 255.0) -> torch.Tensor:
    """Kernel version of ``disc_logistic_plain`` on f32 [rows, E] inputs."""
    _check("disc_logistic", x, mean, log_scale)
    rows, event = _rows_2d("disc_logistic", x)
    out = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows:
        _launch("disc_logistic", _lib().apv_disc_logistic, x.data_ptr(),
                mean.data_ptr(), log_scale.data_ptr(), out.data_ptr(), rows,
                event, float(bin_size), device=x.device)
    return out


def disc_logistic_bwd_plain(g: torch.Tensor, x: torch.Tensor,
                            mean: torch.Tensor, log_scale: torch.Tensor,
                            bin_size: float = 1.0 / 255.0
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """``_disc_logistic_bwd`` written out: g per row -> (dx, dmean,
    dlog_scale), each of x's shape.

    With a = (x − μ + h)/s, b = (x − μ − h)/s and t = bin/s: interior
    dμ = −(1 − σ(b) − σ(a))/s and dls = a·σ(a) − b·(1 − σ(b)) − t/(1 −
    e^{−t}) (1 + t/2 for t ≤ 1e-4); low edge (x ≤ h) dμ = −σ(−a)/s, dls =
    −a·σ(−a); high edge (x ≥ 1 − h) dμ = σ(b)/s, dls = b·σ(b); dx = −dμ."""
    x, mu, ls = (t.to(torch.float32) for t in (x, mean, log_scale))
    inv_s = torch.exp(-ls)
    half = 0.5 * bin_size
    a = (x - mu + half) * inv_s
    b = (x - mu - half) * inv_s
    t = bin_size * inv_s
    sig_a, sig_b = torch.sigmoid(a), torch.sigmoid(b)
    dmu_int = -inv_s * (1.0 - sig_b - sig_a)
    t_term = torch.where(t > 1e-4, t / -torch.expm1(-torch.clamp_min(t, 1e-4)),
                         1.0 + 0.5 * t)
    dls_int = a * sig_a - b * (1.0 - sig_b) - t_term
    is_low = x <= 0.0 + half
    is_high = x >= 1.0 - half
    dmu = torch.where(is_low, -inv_s * torch.sigmoid(-a),
                      torch.where(is_high, inv_s * sig_b, dmu_int))
    dls = torch.where(is_low, -a * torch.sigmoid(-a),
                      torch.where(is_high, b * sig_b, dls_int))
    gb = _per_row(g, x).to(torch.float32)
    return -gb * dmu, gb * dmu, gb * dls


def disc_logistic_bwd_cuda(g: torch.Tensor, x: torch.Tensor,
                           mean: torch.Tensor, log_scale: torch.Tensor,
                           bin_size: float = 1.0 / 255.0, *,
                           want_dx: bool = True
                           ) -> tuple[torch.Tensor | None, torch.Tensor,
                                      torch.Tensor]:
    """Kernel version of ``disc_logistic_bwd_plain`` on f32 g [rows] and x,
    mean, log_scale [rows, E]; dx is None unless ``want_dx``."""
    _check("disc_logistic_bwd", x, mean, log_scale)
    _check_row_grad("disc_logistic_bwd", g, x)
    rows, event = _rows_2d("disc_logistic_bwd", x)
    dmean, dls = torch.empty_like(mean), torch.empty_like(log_scale)
    dx = torch.empty_like(x) if want_dx else None
    if rows:
        _launch("disc_logistic_bwd", _lib().apv_disc_logistic_bwd,
                g.data_ptr(), x.data_ptr(), mean.data_ptr(),
                log_scale.data_ptr(), None if dx is None else dx.data_ptr(),
                dmean.data_ptr(), dls.data_ptr(), rows, event,
                float(bin_size), device=x.device)
    return dx, dmean, dls


# ---------------------------------------------------------------------------
# kl
# ---------------------------------------------------------------------------

def kl_plain(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Per-row KL(q || N(0, I)) -> [rows]."""
    kl = D.gaussian_kl_standard(mean, logvar)
    return kl.reshape(kl.shape[0], -1).sum(dim=-1)


def kl_cuda(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Kernel version of ``kl_plain`` on f32 [rows, Z] inputs."""
    _check("kl", mean, logvar)
    rows, event = _rows_2d("kl", mean)
    out = torch.empty(rows, dtype=torch.float32, device=mean.device)
    if rows:
        _launch("kl", _lib().apv_kl, mean.data_ptr(), logvar.data_ptr(),
                out.data_ptr(), rows, event, device=mean.device)
    return out


def kl_bwd_plain(g: torch.Tensor, mean: torch.Tensor, logvar: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``_kl_bwd``: (dmean, dlogvar) = (g·μ, g·0.5·(e^lv − 1)), g per row."""
    gb = _per_row(g, mean)
    return gb * mean, gb * 0.5 * (torch.exp(logvar) - 1.0)


def kl_bwd_cuda(g: torch.Tensor, mean: torch.Tensor, logvar: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel version of ``kl_bwd_plain`` on f32 g [rows] and [rows, Z]."""
    _check("kl_bwd", mean, logvar)
    _check_row_grad("kl_bwd", g, mean)
    rows, event = _rows_2d("kl_bwd", mean)
    dmean, dlogvar = torch.empty_like(mean), torch.empty_like(logvar)
    if rows:
        _launch("kl_bwd", _lib().apv_kl_bwd, g.data_ptr(), mean.data_ptr(),
                logvar.data_ptr(), dmean.data_ptr(), dlogvar.data_ptr(), rows,
                event, device=mean.device)
    return dmean, dlogvar


# ---------------------------------------------------------------------------
# reparam: Philox4x32-10 + Box-Muller
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_TWO_PI_F32 = 6.2831855               # float32 nearest to 2*pi


def _mulhilo32(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a*b for a, b < 2^32, in int64 without
    overflow: b is multiplied by a's 16-bit halves (< 2^48 each)."""
    t_hi = (a >> 16) * b
    t_lo = (a & 0xFFFF) * b
    lo = (((t_hi & 0xFFFF) << 16) + t_lo) & _MASK32
    hi = (t_hi + (t_lo >> 16)) >> 16
    return hi, lo


def philox4x32_10(counter: tuple[torch.Tensor, ...],
                  key: tuple[int, int]) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 on int64 tensors holding 32-bit words (the same
    rounds as ``csrc/reparam.cu``)."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def _uniform_open(bits: torch.Tensor) -> torch.Tensor:
    """23 random bits -> (m + 0.5) * 2^-23 in (0, 1), exact in float32."""
    return ((bits >> 9).to(torch.float32) + 0.5) * 2.0 ** -23


def philox_normals(total: int, seed: int, offset: int,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """The kernel's stream of ``total`` N(0, 1) draws for (seed, offset)."""
    quads = (total + 3) // 4
    q = torch.arange(quads, dtype=torch.int64, device=device)
    full = torch.full_like
    words = philox4x32_10(
        (q & _MASK32, q >> 32, full(q, offset & _MASK32),
         full(q, (offset >> 32) & _MASK32)),
        (seed & _MASK32, (seed >> 32) & _MASK32))
    out = []
    for b1, b2 in ((words[0], words[1]), (words[2], words[3])):
        u1 = torch.clamp_min(_uniform_open(b1), 1e-12)
        u2 = _uniform_open(b2)
        r = torch.sqrt(-2.0 * torch.log(u1))
        theta = _TWO_PI_F32 * u2
        out += [r * torch.cos(theta), r * torch.sin(theta)]
    return torch.stack(out, dim=1).reshape(-1)[:total]


def draw_key(generator: torch.Generator | None) -> tuple[int, int]:
    """(seed, offset) for one reparam call, from one CPU ``torch.randint``
    on the caller's generator (``None``: torch's default CPU generator)."""
    seed, offset = torch.randint(0, 2 ** 63 - 1, (2,), generator=generator,
                                 dtype=torch.int64).tolist()
    return seed, offset


def reparam_from_eps(mean: torch.Tensor, logvar: torch.Tensor,
                     eps: torch.Tensor) -> torch.Tensor:
    """z = mean + exp(logvar/2) * eps (eps broadcasts over leading axes)."""
    return mean.to(torch.float32) + torch.exp(
        0.5 * logvar.to(torch.float32)) * eps


def reparam_plain(mean: torch.Tensor, logvar: torch.Tensor, samples: int,
                  seed: int, offset: int) -> torch.Tensor:
    """[samples, *mean.shape] draws, the same stream as ``reparam_cuda``."""
    eps = philox_normals(samples * mean.numel(), seed, offset, mean.device)
    return reparam_from_eps(mean, logvar,
                            eps.reshape((samples,) + tuple(mean.shape)))


def reparam_cuda(mean: torch.Tensor, logvar: torch.Tensor, samples: int,
                 seed: int, offset: int) -> torch.Tensor:
    """Kernel version of ``reparam_plain``: f32 [*shape] -> [samples, *shape]."""
    _check("reparam", mean, logvar)
    if samples < 0:
        raise ValueError(f"reparam: samples must be >= 0, got {samples}")
    z = torch.empty((samples,) + tuple(mean.shape), dtype=torch.float32,
                    device=mean.device)
    if z.numel():
        _launch("reparam", _lib().apv_reparam, mean.data_ptr(),
                logvar.data_ptr(), z.data_ptr(), samples, mean.numel(),
                seed, offset, device=mean.device)
    return z


def reparam_bwd_plain(g: torch.Tensor, z: torch.Tensor, mean: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``_reparam_bwd`` + ``_unbroadcast``: g and z [S, *shape], mean
    [*shape] -> (Σ_s g, Σ_s 0.5·g·(z − μ)), each of mean's shape.

    The sums run over s = 0, 1, ... in order, as the kernel's do (a
    reduction in another order differs by a few ulps per sample)."""
    terms = g * 0.5 * (z - mean)
    dmean, dlogvar = torch.zeros_like(mean), torch.zeros_like(mean)
    for s in range(g.shape[0]):
        dmean, dlogvar = dmean + g[s], dlogvar + terms[s]
    return dmean, dlogvar


def reparam_bwd_cuda(g: torch.Tensor, z: torch.Tensor, mean: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel version of ``reparam_bwd_plain`` on f32 tensors."""
    _check("reparam_bwd", g, z)
    _check_each("reparam_bwd", mean)
    if g.dim() < 1 or tuple(g.shape[1:]) != tuple(mean.shape) \
            or mean.device != g.device:
        raise ValueError(f"reparam_bwd: gradient {tuple(g.shape)} is not "
                         f"[S, *{tuple(mean.shape)}] on {mean.device}")
    dmean, dlogvar = torch.empty_like(mean), torch.empty_like(mean)
    if mean.numel():
        _launch("reparam_bwd", _lib().apv_reparam_bwd, g.data_ptr(),
                z.data_ptr(), mean.data_ptr(), dmean.data_ptr(),
                dlogvar.data_ptr(), g.shape[0], mean.numel(),
                device=mean.device)
    return dmean, dlogvar
