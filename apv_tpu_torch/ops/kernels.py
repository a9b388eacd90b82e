"""Hand-written CUDA kernels, their ctypes wrappers, launch counters and
plain PyTorch versions.

Each forward kernel replaces one Pallas TPU kernel of
``apv_tpu/ops/kernels.py`` and computes the same function (not the same
blocks); each backward kernel replaces the jnp rule of that op's
``custom_vjp``:

* ``bernoulli`` (``csrc/bernoulli.cu``) replaces ``_bernoulli_fwd`` /
  ``_bernoulli_kernel``. Bound: memory, the logits read once and x once per
  image (10.2 MB at the MNIST IWAE chunk [3200, 784] with x [64, 784]).
  Design: a block a row, a thread per float4, one block reduction.
  ``bernoulli_bwd`` (same file) replaces ``_bernoulli_bwd``: elementwise,
  a thread per float4 and ``blockIdx.y`` the row (the grid fills the card
  at the train step's [256, 784]), dx written only when asked for.
* ``disc_logistic`` (``csrc/disc_logistic.cu``) replaces
  ``_disc_logistic_fwd`` / ``_disc_logistic_kernel``. Bound: memory, mean
  and log_scale read once and x once per image (79.4 MB at the OOD chunk
  [3200, 3072] with x [64, 3072]). Design: a block a row, one accurate
  exp, two approximate exps, one expm1 and one approximate log an element,
  float4 loads, a block reduction, [rows] written.
  ``disc_logistic_bwd`` (same file) replaces
  ``_disc_logistic_bwd``: elementwise in a block a row, bound by memory
  (15.7 MB at the train step's [256, 3072] without dx), dx written only
  when asked for.
* The two likelihood forwards take x with B rows beside parameters with
  R = S·B rows: parameter row r reads x row r % B, the order of
  ``x.expand(S, B, ...).reshape(S·B, ...)``, so the IWAE and OOD paths
  score each image under S samples without copying it S times.
* ``kl`` (``csrc/kl.cu``) replaces ``_kl_fwd`` / ``_kl_kernel``. Bound:
  launch latency (65.5 KB at [64, 128]). Design: one warp per row.
  ``kl_bwd`` (same file) replaces ``_kl_bwd``.
* ``reparam`` (``csrc/reparam.cu``) replaces ``_reparam_fwd`` /
  ``_reparam_kernel``. Bound: launch latency (0.82 MB written at
  [25, 64, 128]). Design: Philox4x32-10 + Box-Muller inside the kernel,
  one counter (four outputs) a thread with one 32-bit remainder and one
  16-byte store; mean and logvar are read as [B, Z] for all S samples.
  ``reparam_bwd``
  (same file) replaces ``_reparam_bwd`` + ``_unbroadcast``: one thread per
  element sums over the sample axis, deterministic, no atomics.
* ``groupnorm_gelu`` (``csrc/groupnorm_gelu.cu``) replaces
  ``apv_tpu/ops/groupnorm.py::_fwd`` / ``_gn_gelu_kernel``. Bound: memory,
  x in and y out (67.1 MB in bf16 at [256, 32, 32, 64]). Design: a
  cluster of blocks per image reading whole pixel rows in 16-byte runs,
  each block's per-group (count, mean, M2) meeting the others' in
  distributed shared memory and combined in rank order (other shapes: a
  block per (row, group), one channel a thread). ``groupnorm_gelu_bwd``
  (same file) replaces the rule ``_bwd`` in the same two layouts, on the
  same shapes; dgamma and dbeta as per-row partials summed in a fixed
  order. ``groupnorm_gelu_routes`` and ``groupnorm_gelu_bwd_routes`` count
  each direction's launches by the kernel that ran.
* ``conv3x3`` (``csrc/conv3x3.cu``) replaces
  ``scripts/conv_microbench.py::pallas_conv``. Bound: bytes at the probe's
  stage 1 (100.7 MB in bf16 with the f32 out), bf16 tensor-core operations
  at stages 2-3 (19.3 GFLOP at each shape). Design: an implicit GEMM on
  the tensor cores (``conv3x3_wgmma``: wgmma fed by TMA boxes of x and w
  through an mbarrier ring of 128-byte-swizzled stages, a producer thread
  and two consumer warpgroups, persistent; bf16, or 3xTF32 for f32) where
  Cin and Cout are multiples of 8, else f32 FMAs over shared-memory tiles
  (``conv3x3_simt``); ``conv3x3_route`` states the rule.

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

import ctypes
import math

import torch

from apv_tpu_torch.core import distributions as D

# Launch count per kernel, incremented by the wrappers only.
launches: dict[str, int] = {
    "reparam": 0, "kl": 0, "disc_logistic": 0, "bernoulli": 0,
    "reparam_bwd": 0, "kl_bwd": 0, "bernoulli_bwd": 0,
    "disc_logistic_bwd": 0, "groupnorm_gelu": 0, "groupnorm_gelu_bwd": 0,
    "conv3x3": 0}
# conv3x3's launches by the kernel that ran (``conv3x3_route``'s names)
conv3x3_routes: dict[str, int] = {"wgmma": 0, "simt": 0}
# groupnorm_gelu's and groupnorm_gelu_bwd's launches by the kernel that
# ran, as the C entry points report it (``groupnorm_gelu_image`` or
# ``_rows``; ``groupnorm_gelu_bwd_image`` or ``_rows``)
GN_KERNELS = ("image", "rows")
groupnorm_gelu_routes: dict[str, int] = dict.fromkeys(GN_KERNELS, 0)
groupnorm_gelu_bwd_routes: dict[str, int] = dict.fromkeys(GN_KERNELS, 0)


def reset_launches() -> None:
    for counts in (launches, conv3x3_routes, groupnorm_gelu_routes,
                   groupnorm_gelu_bwd_routes):
        for name in counts:
            counts[name] = 0


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


def _x_rows(name: str, x: torch.Tensor, params: torch.Tensor) -> int:
    """x's rows B where ``params`` has R rows: B divides R, the rest of
    the shapes are equal. Row r of ``params`` pairs with x's row r % B."""
    if (x.shape[1:] != params.shape[1:] or x.dim() == 0
            or (x.shape[0] == 0) != (params.shape[0] == 0)
            or (x.shape[0] and params.shape[0] % x.shape[0])):
        raise ValueError(f"{name}: x {tuple(x.shape)} does not pair with "
                         f"parameters {tuple(params.shape)}: x needs their "
                         "trailing shape and a row count B that divides "
                         "theirs (row r reads x row r % B)")
    return x.shape[0]


def _check_x(name: str, x: torch.Tensor, params: torch.Tensor) -> int:
    """The CUDA wrappers' x: checked as every input, on the parameters'
    device, paired with them by ``_x_rows``."""
    _check_each(name, x)
    if x.device != params.device:
        raise ValueError(f"{name}: inputs differ in device: x on {x.device}, "
                         f"parameters on {params.device}")
    return _x_rows(name, x, params)


def expand_rows(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """x [B, ...] repeated to ``like``'s R = S·B rows, sample-major (row r
    is x's row r % B); x itself when B = R."""
    b = _x_rows("expand_rows", x, like)
    if b == like.shape[0]:
        return x
    s = like.shape[0] // b
    return x.unsqueeze(0).expand((s,) + tuple(x.shape)).reshape(like.shape)


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
    """Per-row sum of x·l − softplus(l) -> [rows]; x may have B rows where
    the logits have S·B (``expand_rows``)."""
    ll = D.bernoulli_logpmf(expand_rows(x, logits), logits)
    return ll.reshape(ll.shape[0], -1).sum(dim=-1)


def bernoulli_cuda(x: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Kernel version of ``bernoulli_plain`` on f32 logits [rows, E] and x
    [B, E], B dividing rows (row r reads x row r % B)."""
    _check("bernoulli", logits)
    rows, event = _rows_2d("bernoulli", logits)
    x_rows = _check_x("bernoulli", x, logits)
    out = torch.empty(rows, dtype=torch.float32, device=logits.device)
    if rows:
        _launch("bernoulli", _lib().apv_bernoulli, x.data_ptr(),
                logits.data_ptr(), out.data_ptr(), rows, event, x_rows,
                device=logits.device)
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
    """Per-row sum of the discretized-logistic log pmf -> [rows]; x may have
    B rows where mean and log_scale have S·B (``expand_rows``)."""
    ll = D.discretized_logistic_logpmf(expand_rows(x, mean), mean, log_scale,
                                       bin_size=bin_size)
    return ll.reshape(ll.shape[0], -1).sum(dim=-1)


def disc_logistic_cuda(x: torch.Tensor, mean: torch.Tensor,
                       log_scale: torch.Tensor,
                       bin_size: float = 1.0 / 255.0) -> torch.Tensor:
    """Kernel version of ``disc_logistic_plain`` on f32 mean, log_scale
    [rows, E] and x [B, E], B dividing rows (row r reads x row r % B)."""
    _check("disc_logistic", mean, log_scale)
    rows, event = _rows_2d("disc_logistic", mean)
    x_rows = _check_x("disc_logistic", x, mean)
    out = torch.empty(rows, dtype=torch.float32, device=mean.device)
    if rows:
        _launch("disc_logistic", _lib().apv_disc_logistic, x.data_ptr(),
                mean.data_ptr(), log_scale.data_ptr(), out.data_ptr(), rows,
                event, x_rows, float(bin_size), device=mean.device)
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
    """(seed, offset) for one reparam call, from one ``torch.randint`` on
    the caller's generator, on the generator's device (``None``: torch's
    default CPU generator)."""
    dev = generator.device if generator is not None else "cpu"
    seed, offset = torch.randint(0, 2 ** 63 - 1, (2,), generator=generator,
                                 dtype=torch.int64, device=dev).tolist()
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


# ---------------------------------------------------------------------------
# groupnorm_gelu: fused GroupNorm + tanh-GELU over NHWC, and its rule
# ---------------------------------------------------------------------------

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_GN_DTYPES = (torch.float32, torch.bfloat16)


def gelu_tanh(v: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of GELU (``jax.nn.gelu(approximate=True)``,
    flax's default)."""
    return 0.5 * v * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (v + 0.044715 * v ** 3)))


def _group_shape(x: torch.Tensor, groups: int) -> tuple[int, int, int]:
    """(B, HW, C) of NHWC x; raise unless C % groups == 0."""
    if x.dim() != 4:
        raise ValueError(f"groupnorm_gelu: expects NHWC x, got "
                         f"{tuple(x.shape)}")
    b, h, w, c = x.shape
    if groups < 1 or c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    return b, h * w, c


def groupnorm_gelu_plain(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, groups: int = 8,
                         eps: float = 1e-6
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_reference`` with the residuals of ``_fwd``: (y in x's dtype, mean
    [B, G], rstd [B, G]); float32 statistics, two-pass variance."""
    b, hw, c = _group_shape(x, groups)
    xf = x.to(torch.float32).reshape(b, hw, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = ((xf - mean) * rstd).reshape(b, hw, c)
    y = gelu_tanh(xhat * gamma.to(torch.float32) + beta.to(torch.float32))
    return (y.reshape(x.shape).to(x.dtype), mean.reshape(b, groups),
            rstd.reshape(b, groups))


def groupnorm_gelu_bwd_plain(dy: torch.Tensor, x: torch.Tensor,
                             gamma: torch.Tensor, beta: torch.Tensor,
                             mean: torch.Tensor, rstd: torch.Tensor,
                             groups: int = 8
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The rule ``_bwd`` written out: (dx in x's dtype, dgamma, dbeta in
    float32). With y_pre = xhat·γ + β: dy_pre = dy·gelu'(y_pre), dgamma =
    Σ dy_pre·xhat, dbeta = Σ dy_pre, dxhat = dy_pre·γ and dx = rstd·(dxhat
    − mean_g(dxhat) − xhat·mean_g(dxhat·xhat))."""
    b, hw, c = _group_shape(x, groups)
    cg = c // groups
    xf = x.to(torch.float32).reshape(b, hw, groups, cg)
    xhat = (xf - mean[:, None, :, None]) * rstd[:, None, :, None]
    xhat2 = xhat.reshape(b, hw, c)
    g32, b32 = gamma.to(torch.float32), beta.to(torch.float32)
    y_pre = xhat2 * g32 + b32
    th = torch.tanh(_SQRT_2_OVER_PI * (y_pre + 0.044715 * y_pre ** 3))
    dgelu = 0.5 * (1.0 + th) + 0.5 * y_pre * (1.0 - th ** 2) \
        * _SQRT_2_OVER_PI * (1.0 + 3 * 0.044715 * y_pre ** 2)
    dy_pre = dy.to(torch.float32).reshape(b, hw, c) * dgelu
    dgamma = (dy_pre * xhat2).sum(dim=(0, 1))
    dbeta = dy_pre.sum(dim=(0, 1))
    dxhat = (dy_pre * g32).reshape(b, hw, groups, cg)
    m1 = dxhat.mean(dim=(1, 3), keepdim=True)
    m2 = (dxhat * xhat).mean(dim=(1, 3), keepdim=True)
    dx = rstd[:, None, :, None] * (dxhat - m1 - xhat * m2)
    return dx.reshape(x.shape).to(x.dtype), dgamma, dbeta


def _check_gn(name: str, x: torch.Tensor, *f32: torch.Tensor) -> None:
    """x bf16 or f32 NHWC, the rest f32 (gamma, beta or statistics); all
    CUDA, contiguous and without grad."""
    if x.dtype not in _GN_DTYPES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.requires_grad:
        _check_each(name, x)              # raises the no-grad message
    if x.device.type != "cuda":
        raise ValueError(f"{name}: CUDA kernel got a tensor on {x.device}; "
                         "the plain version takes CPU ones")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expects contiguous NHWC x (a "
                         "channels_last NCHW tensor's permute(0, 2, 3, 1))")
    _check_each(name, *f32)
    if any(t.device != x.device for t in f32):
        raise ValueError(f"{name}: inputs on different devices")


def groupnorm_gelu_cuda(x: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, groups: int = 8,
                        eps: float = 1e-6
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel version of ``groupnorm_gelu_plain``: NHWC x (bf16 or f32),
    f32 gamma and beta [C] -> (y, mean [B, G], rstd [B, G]). The C entry
    point picks the kernel by the rule of the backward and reports it; each
    launch adds one to ``groupnorm_gelu_routes`` under the kernel that
    ran."""
    b, hw, c = _group_shape(x, groups)
    _check_gn("groupnorm_gelu", x, gamma, beta)
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"groupnorm_gelu: gamma, beta must be [{c}], got "
                         f"{tuple(gamma.shape)}, {tuple(beta.shape)}")
    y = torch.empty_like(x)
    mean = torch.empty((b, groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if x.numel():
        ran = ctypes.c_int(-1)
        _launch("groupnorm_gelu", _lib().apv_groupnorm_gelu, x.data_ptr(),
                gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
                mean.data_ptr(), rstd.data_ptr(), b, hw, c, groups,
                float(eps), int(x.dtype == torch.bfloat16),
                ctypes.byref(ran), device=x.device)
        groupnorm_gelu_routes[GN_KERNELS[ran.value]] += 1
    return y, mean, rstd


def groupnorm_gelu_bwd_cuda(dy: torch.Tensor, x: torch.Tensor,
                            gamma: torch.Tensor, beta: torch.Tensor,
                            mean: torch.Tensor, rstd: torch.Tensor,
                            groups: int = 8
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Kernel version of ``groupnorm_gelu_bwd_plain``: dy and x of one
    dtype and shape, the forward's f32 residuals -> (dx, dgamma, dbeta).
    The C entry point picks the kernel (by widths, alignment and the
    image's size) and reports it; each launch adds one to
    ``groupnorm_gelu_bwd_routes`` under the kernel that ran."""
    b, hw, c = _group_shape(x, groups)
    _check_gn("groupnorm_gelu_bwd", x, gamma, beta, mean, rstd)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous() or dy.requires_grad:
        raise ValueError("groupnorm_gelu_bwd: dy must match x in shape, "
                         "dtype and device, contiguous and without grad")
    if gamma.shape != (c,) or beta.shape != (c,) \
            or mean.shape != (b, groups) or rstd.shape != (b, groups):
        raise ValueError("groupnorm_gelu_bwd: gamma, beta [C] and mean, "
                         "rstd [B, G] expected")
    dx = torch.empty_like(x)
    partials = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
    dbeta = torch.empty_like(dgamma)
    if c:
        ran = ctypes.c_int(-1)            # stays -1 when B = 0
        _launch("groupnorm_gelu_bwd", _lib().apv_groupnorm_gelu_bwd,
                dy.data_ptr(), x.data_ptr(), gamma.data_ptr(),
                beta.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                dx.data_ptr(), partials[0].data_ptr(),
                partials[1].data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
                b, hw, c, groups, int(x.dtype == torch.bfloat16),
                ctypes.byref(ran), device=x.device)
        if ran.value >= 0:
            groupnorm_gelu_bwd_routes[GN_KERNELS[ran.value]] += 1
    return dx, dgamma, dbeta


# ---------------------------------------------------------------------------
# conv3x3: 3x3 SAME stride-1 conv, NHWC x, HWIO w, f32 out
# ---------------------------------------------------------------------------

def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in torch ops: x and w widened to f32, then
    nine shifted [B·H·W, Cin] × [Cin, Cout] products summed in f32 ->
    [B, H, W, Cout] f32."""
    b, h, wd, c = x.shape
    xf = torch.nn.functional.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1))
    wf = w.to(torch.float32)
    out = torch.zeros((b * h * wd, w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for ky in range(3):
        for kx in range(3):
            patch = xf[:, ky:ky + h, kx:kx + wd, :].reshape(-1, c)
            out = out + patch @ wf[ky, kx]
    return out.reshape(b, h, wd, w.shape[-1])


def conv3x3_route(cin: int, cout: int) -> str:
    """The kernel ``conv3x3_cuda`` launches for these widths: ``"wgmma"``
    (tensor cores) when Cin and Cout are multiples of 8, else ``"simt"``
    (f32 FMAs). Both dtypes follow the same rule."""
    return "wgmma" if cin % 8 == 0 and cout % 8 == 0 else "simt"


def conv3x3_kmajor(w: torch.Tensor) -> torch.Tensor:
    """HWIO w as the tensor-core kernel reads it: [Cout, 9·Cin], row n
    holding Wf[:, n] with k = (ky·3 + kx)·Cin + ci (a contiguous copy)."""
    return w.reshape(-1, w.shape[-1]).t().contiguous()


def conv3x3_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Kernel version of ``conv3x3_plain``: x [B, H, W, Cin] and w [3, 3,
    Cin, Cout], both bf16 or both f32, CUDA and contiguous -> f32 out.
    ``conv3x3_route`` picks the kernel by the widths alone; on f32 the
    tensor-core one reads ``conv3x3_kmajor(w)``, a copy made here (TF32
    wgmma takes K-major B only), on bf16 w itself. It reads x and w
    through TMA, whose base addresses must be 16-byte aligned: a view off
    that alignment is copied first. Each launch also adds one to
    ``conv3x3_routes`` under the kernel that ran."""
    if x.dtype not in _GN_DTYPES or w.dtype != x.dtype:
        raise TypeError(f"conv3x3: x and w must both be float32 or both "
                        f"bfloat16, got {x.dtype}, {w.dtype}")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) \
            or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3: x [B,H,W,Cin] and w [3,3,Cin,Cout] "
                         f"expected, got {tuple(x.shape)}, {tuple(w.shape)}")
    for t in (x, w):
        if t.requires_grad:
            _check_each("conv3x3", t)     # raises the no-grad message
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"conv3x3: CUDA kernel got a tensor on "
                             f"{t.device}; the plain version takes CPU ones")
        if not t.is_contiguous():
            raise ValueError("conv3x3: expects contiguous NHWC x and HWIO w")
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    out = torch.empty((b, h, wd, cout), dtype=torch.float32, device=x.device)
    if not out.numel():
        return out
    sizes = (b, h, wd, cin, cout, int(x.dtype == torch.bfloat16))
    route = conv3x3_route(cin, cout)
    if route == "wgmma":
        if x.data_ptr() % 16:             # TMA's base address: a fresh
            x = x.clone()                 # allocation is aligned
        wb = w if x.dtype == torch.bfloat16 else conv3x3_kmajor(w)
        if wb.data_ptr() % 16:
            wb = wb.clone()
        _launch("conv3x3", _lib().apv_conv3x3_wgmma, x.data_ptr(),
                wb.data_ptr(), out.data_ptr(), *sizes, device=x.device)
    else:
        _launch("conv3x3", _lib().apv_conv3x3_simt, x.data_ptr(),
                w.data_ptr(), out.data_ptr(), *sizes, device=x.device)
    conv3x3_routes[route] += 1
    return out
