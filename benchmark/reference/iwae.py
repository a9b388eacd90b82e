"""The reference's IWAE-k scores under the learned adversarial prior.

log p(x) ≈ logsumexp_i [log p(x|z_i) + log N(z_i; 0, I) + D(z_i) − log Z
− log q(z_i|x)] − log k, z_i = μ + e^{lv/2}·ε_i, the k draws of batch b
of a call with seed s coming in chunks from the keys of a CPU generator
seeded s + b, one key a chunk, each key's normals laid out [chunk, B, Z].
log Z = log E_{u~N(0,I)}[e^{D(u)}] over 100,000 draws in 20 blocks of
5,000 from a device generator seeded s + 17. Continuous images are scored
as bin centres x/255 and encoded centred to [−1, 1]; binary images are
scored and encoded as they are.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import likelihood as L
from benchmark.reference import stream

LOG_Z_DRAWS, LOG_Z_BLOCK, LOG_Z_SEED_OFFSET = 100_000, 5_000, 17


@torch.no_grad()
def log_partition(d, z_dim: int, seed: int, device) -> float:
    gen = torch.Generator(device=device).manual_seed(seed + LOG_Z_SEED_OFFSET)
    blocks = [torch.logsumexp(d(torch.randn((LOG_Z_BLOCK, z_dim),
                                            generator=gen, device=device)),
                              dim=0)
              for _ in range(LOG_Z_DRAWS // LOG_Z_BLOCK)]
    return float(torch.logsumexp(torch.stack(blocks).double(), dim=0)
                 - math.log(LOG_Z_DRAWS))


def prep(images_u8: torch.Tensor, binary: bool):
    """(encoder input, likelihood target) of uint8 images."""
    if binary:
        x = images_u8.to(torch.float32)
        return x, x
    levels = images_u8.to(torch.float32) / 255.0
    return levels * 2.0 - 1.0, levels


@torch.no_grad()
def scores(vae, d, images_u8: torch.Tensor, rows: list[int], *, batch: int,
           k: int, chunk: int, seed: int, likelihood: str, binary: bool,
           log_z: float, block_rows: int = 512) -> dict[int, float]:
    """log p(x) estimates of the call's images at ``rows`` (indices into
    ``images_u8``, the call's images in order, ``batch`` to a batch)."""
    dev = images_u8.device
    out: dict[int, float] = {}
    by_batch: dict[int, list[int]] = {}
    for r in sorted(rows):
        by_batch.setdefault(r // batch, []).append(r)
    for b, rs in by_batch.items():
        gen = torch.Generator().manual_seed(seed + b)
        keys = [stream.draw_key(gen) for _ in range(k // chunk)]
        sel = torch.tensor([r % batch for r in rs], device=dev)
        x_in, x_t = prep(images_u8[torch.tensor(rs, device=dev)], binary)
        mean, logvar = vae.encode(x_in)                    # [n, Z]
        n, zd = mean.shape
        eps = torch.cat([stream.normals(chunk * batch * zd, *key, dev)
                         .reshape(chunk, batch, zd)[:, sel]
                         for key in keys])                  # [k, n, Z]
        z = mean + torch.exp(0.5 * logvar) * eps
        logq = L.gaussian_logpdf(z, mean, logvar).sum(-1)   # [k, n]
        logp = L.standard_logpdf(z).sum(-1)
        zf = z.reshape(k * n, zd)
        target = x_t.unsqueeze(0).expand(k, *x_t.shape).reshape(
            k * n, *x_t.shape[1:])
        recon = torch.cat([
            L.recon_ll(likelihood, target[i:i + block_rows],
                       vae.decode(zf[i:i + block_rows]))
            for i in range(0, k * n, block_rows)]).reshape(k, n)
        logw = recon + logp - logq
        if d is not None:
            logw = logw + d(zf).reshape(k, n) - log_z
        est = torch.logsumexp(logw.double(), dim=0) - math.log(k)
        out.update(zip(rs, est.tolist()))
    return out
