"""The FLOP counts behind ``mfu`` and the bytes and operations behind the
kernel rooflines, at small shapes worked out by hand."""

from __future__ import annotations

import pytest

from benchmark.harness import counts, peaks, trace
from benchmark.harness.stretch import (Stretch, kernel_roofline, mfu,
                                       port_functions, roofline_kernels)


def _conv(h, w, cin, cout, k):            # 2 operations a multiply-add
    return 2 * h * w * cin * cout * k * k


def _tiny_resnet():
    return {"model": {"family": "resnet", "z_dim": 4, "widths": [2, 4],
                      "blocks_per_stage": 1, "image_shape": [4, 4, 3],
                      "likelihood": "discretized_logistic", "norm": "rms",
                      "upsample": "conv_transpose", "activation": "silu",
                      "prior": "standard"},
            "adversarial": {"enabled": True, "variant": "learned_prior",
                            "d_widths": [3], "d_spectral_norm": False}}


def test_resnet_forward_flops_by_hand():
    f = counts.forward_flops(_tiny_resnet())
    stem = _conv(4, 4, 3, 2, 3)
    enc = (stem + 2 * _conv(4, 4, 2, 2, 3)        # block at width 2
           + _conv(2, 2, 2, 4, 3)                 # stride-2 down 2->4, 2x2
           + 2 * _conv(2, 2, 4, 4, 3)             # block at width 4
           + 2 * (2 * 2 * 4) * 8)                 # head 16 -> 2*z
    dec = (2 * 4 * (2 * 2 * 4)                    # dense z -> 2x2x4
           + 2 * _conv(2, 2, 4, 4, 3)             # block at width 4
           + 2 * 2 * 2 * 4 * 2 * 16               # 4x4 transposed 4->2
           + 2 * _conv(4, 4, 2, 2, 3)             # block at width 2
           + _conv(4, 4, 2, 6, 3))                # head -> 2C
    d = 2 * 4 * 3 + 2 * 3 * 1
    assert f == {"encoder": enc, "decoder": dec, "stem": stem, "d": d}
    assert counts.train_flops_per_image(_tiny_resnet()) == (
        3 * (enc + dec) - stem + 6 * d)
    assert counts.iwae_flops_per_image(_tiny_resnet(), 10) == (
        enc + 10 * (dec + d))


def test_conv_vae_forward_flops_by_hand():
    cfg = {"model": {"family": "conv", "z_dim": 2, "widths": [2, 2],
                     "dense": 3, "image_shape": [4, 4, 1],
                     "likelihood": "bernoulli", "activation": "gelu",
                     "prior": "standard"},
           "adversarial": {"enabled": False}}
    f = counts.forward_flops(cfg)
    enc = (_conv(2, 2, 1, 2, 3) + _conv(2, 2, 2, 2, 3)      # 4 -> 2
           + _conv(1, 1, 2, 2, 3) + _conv(1, 1, 2, 2, 3)    # 2 -> 1
           + 2 * 2 * 3 + 2 * 3 * 4)                         # dense, head
    dec = (2 * 2 * 3 + 2 * 3 * 2                            # 1x1x2 map
           + 2 * _conv(2, 2, 2, 2, 3) + 2 * _conv(4, 4, 2, 2, 3)
           + _conv(4, 4, 2, 1, 3))                          # head
    assert f == {"encoder": enc, "decoder": dec,
                 "stem": _conv(2, 2, 1, 2, 3), "d": 0}


@pytest.mark.parametrize("name,shape,want", [
    ("reparam", dict(samples=2, n=8, rows=2, kl=False),
     (4 * (16 + 16), 33 * 16)),
    ("reparam", dict(samples=1, n=8, rows=2, kl=True),
     (4 * (16 + 8 + 2), 33 * 8 + 6 * 8)),
    ("reparam_bwd", dict(samples=1, n=8, rows=2, kl=True),
     (4 * (16 + 16 + 2 + 16), 5 * 8 + 7 * 8)),
    ("reparam_bwd", dict(samples=3, n=8, rows=2, kl=False),
     (4 * (48 + 8 + 16), 5 * 24)),
    ("disc_logistic", dict(rows=6, event=5, x_rows=2),
     (4 * (60 + 10 + 6), 30 * 30)),
    ("disc_logistic_bwd", dict(rows=6, event=5), (4 * (6 + 90 + 60),
                                                  30 * 30)),
    ("bernoulli", dict(rows=6, event=5, x_rows=3), (4 * (30 + 15 + 6),
                                                    7 * 30)),
])
def test_kernel_work(name, shape, want):
    assert counts.kernel_work(name, **shape) == want


def test_kernel_roofline_reads_only_what_the_shapes_account_for():
    nbytes, ops = counts.kernel_work("disc_logistic", rows=1600,
                                     event=3072, x_rows=64)
    least = counts.least_seconds(nbytes, ops, peaks.MEM_BW["H100"],
                                 peaks.F32_OPS)
    ev = [trace.Event("void ns::disc_logistic_rows<4>(float)", "kernel",
                      0.0, 2 * least * 1e6),
          trace.Event("void ns::reparam_samples<64, false>()", "kernel",
                      0.0, 10.0)]
    s = Stretch(unit="iwae", events=ev, images=64,
                kernels={"disc_logistic": {"launches": 1, "bytes": nbytes,
                                           "ops": ops}},
                counted={"disc_logistic": (1, 1)}, card="NVIDIA H100 80GB")
    assert kernel_roofline(s, "iwae") == pytest.approx(50.0)
    # the share names what it covers and what it leaves out, and why
    k = roofline_kernels(s)
    assert list(k["in"]) == ["disc_logistic"]
    assert k["in"]["disc_logistic"]["launches"] == 1
    assert list(k["out"]) == ["reparam_samples"]
    assert k["out"]["reparam_samples"]["launches"] == 1
    assert "no shapes" in k["out"]["reparam_samples"]["why"]
    # the program counted another number of launches: nothing to read,
    # and the kernel is named as left out
    s.counted = {"disc_logistic": (2, 1)}
    assert kernel_roofline(s, "iwae") is None
    assert kernel_roofline(s, "train") is None
    k = roofline_kernels(s)
    assert k["in"] == {}
    assert "program's count 2" in k["out"]["disc_logistic"]["why"]


def test_port_functions_are_the_programs_kernels():
    found = port_functions()
    for fn in counts.KERNEL_FUNCTIONS.values():
        assert fn in found
    assert "conv3x3_wgmma" in found and "groupnorm_gelu_image" in found


def test_mfu_against_the_bf16_peak():
    s = Stretch(unit="train", events=[], flops_per_image=10 ** 9,
                timed_images=989, timed_seconds=1.0)
    assert mfu(s, "train") == pytest.approx(0.1)
    assert mfu(s, "iwae") is None
