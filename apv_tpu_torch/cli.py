"""The port's CLI: ``apv-torch {train,evaluate,sample,ood,export,presets,
info} --preset <name> [--set k=v ...]`` (counterpart of
``apv_tpu/cli.py``), also ``python -m apv_tpu_torch.cli``.

Commands run on the CUDA card unless ``--device cpu``. ``presets`` and
``info`` read only the config registry and the results dir: they touch no
device. ``sample --visualize reconstruct|interpolate|latent`` writes the
reconstruction, interpolation or latent-scatter PNG instead of prior
samples; the flags of prior sampling that it would ignore are refused.
``export`` writes a ``torch.export`` serving artifact (``.pt2``) for the
device it runs on, ``--temperature`` included. ``train --distributed``
joins the process group that the APV_COORDINATOR, APV_NUM_PROCESSES and
APV_PROCESS_ID env vars describe (one process a card, started once a card
by the launcher; ``parallel/multihost.py``) before anything touches the
card, and exits nonzero when APV_COORDINATOR is unset.
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_common(p: argparse.ArgumentParser, default_preset: str) -> None:
    p.add_argument("--preset", default=default_preset,
                   help="named config preset")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="PATH=VALUE",
                   help="dot-path config override, e.g. train.lr=3e-4")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--debug-nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly(True): raise at "
                        "the op whose backward makes a NaN (slow)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the CUDA card (default) or on the CPU "
                        "(the kernels' plain PyTorch versions)")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="apv-torch",
        description="adversarial-prior VAE framework, PyTorch/CUDA port")
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="train a model")
    _add_common(p_train, "mnist_vae")
    p_train.add_argument("--resume", action="store_true")
    p_train.add_argument("--overwrite", action="store_true",
                         help="let a fresh (non-resume) run clear an "
                              "existing run of the same name (refused "
                              "otherwise)")
    p_train.add_argument("--max-steps", type=int, default=None)
    p_train.add_argument("--trace-dir", default=None,
                         help="write a torch.profiler trace of this run's "
                              "steps 10-15 into this dir; it names the "
                              "program's spans (loop.step, step.g_phase, "
                              "...) as user_annotation ranges")
    p_train.add_argument("--distributed", action="store_true",
                         help="data-parallel training, one process a card: "
                              "join the group of APV_COORDINATOR (host:port "
                              "of rank 0), APV_NUM_PROCESSES and "
                              "APV_PROCESS_ID")

    p_eval = sub.add_parser("evaluate", help="IWAE-k NLL + bits/dim")
    _add_common(p_eval, "iwae_eval")
    p_eval.add_argument("--dataset", default=None)
    p_eval.add_argument("--k", type=int, default=None)
    p_eval.add_argument("--prior", choices=("model", "expost",
                                            "expost_gmm", "expost_flow"),
                        default="model",
                        help="score under the checkpoint's own prior, or "
                             "an ex-post (Gaussian, GMM or RealNVP-flow) "
                             "prior fitted to the train split: an exact "
                             "density, no log-partition term")
    p_eval.add_argument("--gmm-k", type=int, default=10, metavar="K",
                        help="components for --prior expost_gmm")
    p_eval.add_argument("--flow-steps", type=int, default=2000,
                        metavar="N",
                        help="MLE fit steps for --prior expost_flow")

    p_sample = sub.add_parser("sample", help="decode prior samples to a grid")
    _add_common(p_sample, "mnist_vae")
    p_sample.add_argument("-n", type=int, default=64)
    p_sample.add_argument("--mode", choices=("mean", "sample"),
                          default="mean")
    p_sample.add_argument("--seed", type=int, default=0)
    p_sample.add_argument("--out", default=None)
    p_sample.add_argument("--visualize", choices=("reconstruct",
                                                  "interpolate", "latent"),
                          default=None,
                          help="instead of prior samples: reconstructions "
                               "(-n test images), latent slerps (-n rows, "
                               "--steps columns), or a latent-space scatter "
                               "of the aggregate posterior vs the priors")
    p_sample.add_argument("--steps", type=int, default=8,
                          help="interpolation steps (with --visualize "
                               "interpolate)")
    p_sample.add_argument("--prior", choices=("auto", "standard", "expost",
                                              "expost_gmm", "expost_flow"),
                          default="auto",
                          help="latent draw: the model's own (shaped or "
                               "trained) prior, N(0,I), or an ex-post "
                               "Gaussian, --gmm-k-component GMM or RealNVP "
                               "flow fitted to the test split")
    p_sample.add_argument("--gmm-k", type=int, default=10, metavar="K",
                          help="components for --prior expost_gmm")
    p_sample.add_argument("--flow-steps", type=int, default=2000,
                          metavar="N",
                          help="MLE fit steps for --prior expost_flow")
    p_sample.add_argument("--refine", type=int, default=0, metavar="STEPS",
                          help="MALA steps on the adversarially shaped prior "
                               "after the SIR draw (0 = SIR only)")
    p_sample.add_argument("--temperature", type=float, default=1.0,
                          metavar="T",
                          help="base-draw temperature of the model's own "
                               "trained prior (model.prior=flow/gaussian): "
                               "u ~ N(0, T²I)")
    p_sample.add_argument("--quality", type=int, default=0, metavar="N",
                          help="also compute sample-quality distances over "
                               "N samples -> sample_quality.json")

    p_ood = sub.add_parser("ood", help="OOD scoring suite")
    _add_common(p_ood, "ood_suite")
    p_ood.add_argument("--seed", type=int, default=0)
    p_ood.add_argument("--both", action="store_true",
                       help="also score the reversed dataset-pair direction "
                            "(with the ood.reverse_of checkpoint when set)")

    sub.add_parser("presets",
                   help="list the named config presets with their "
                        "docstrings (touches no device)")

    p_info = sub.add_parser("info",
                            help="list the runs of the results dir, or one "
                                 "run's config, checkpoints, results and "
                                 "last metrics (touches no device)")
    p_info.add_argument("name", nargs="?", default=None,
                        help="run name (omit to list all runs)")
    p_info.add_argument("--results-dir", default="results")

    p_exp = sub.add_parser("export",
                           help="export a serving artifact (torch.export, "
                                "for the device it runs on)")
    _add_common(p_exp, "mnist_vae")
    p_exp.add_argument("--what", choices=("sampler", "scorer"),
                       default="sampler")
    p_exp.add_argument("--out", default=None,
                       help="artifact path (default "
                            "<results_dir>/<name>/<what>.pt2)")
    p_exp.add_argument("--refine", type=int, default=0, metavar="STEPS",
                       help="bake STEPS MALA refinement steps on the "
                            "shaped prior into the sampler artifact")
    p_exp.add_argument("--prior", choices=("auto", "standard", "expost",
                                           "expost_gmm", "expost_flow"),
                       default="auto",
                       help="sampler artifact's latent draw; 'expost' "
                            "bakes an aggregate-posterior Gaussian fit "
                            "(computed at export time) in as constants; "
                            "'expost_gmm' a --gmm-k-component GMM fit; "
                            "'expost_flow' a RealNVP flow fit")
    p_exp.add_argument("--gmm-k", type=int, default=10, metavar="K",
                       help="components for --prior expost_gmm")
    p_exp.add_argument("--flow-steps", type=int, default=2000, metavar="N",
                       help="MLE fit steps for --prior expost_flow")
    p_exp.add_argument("--temperature", type=float, default=1.0,
                       metavar="T",
                       help="bake a base-draw temperature into trained-"
                            "prior samplers (model.prior=flow/gaussian: "
                            "u ~ N(0, T²I) before the inverse/base pass)")
    p_exp.add_argument("--quantize", choices=("int8",), default=None,
                       help="weight-only post-training quantization of the "
                            "baked params (sampler only; ~4x smaller)")
    return parser


def main(argv: list[str] | None = None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    if args.command == "info":
        from apv_tpu_torch.api import info
        print(json.dumps(info(args.name, results_dir=args.results_dir),
                         indent=2))
        return 0
    if args.command == "presets":
        from apv_tpu_torch.utils.config import PORT_PRESETS, PRESETS
        for name, factory in {**PRESETS, **PORT_PRESETS}.items():
            doc = ((factory.__doc__ or "").strip().splitlines() or [""])[0]
            print(f"{name:24s} {doc}")
        return 0
    if args.command == "train":
        if args.checkpoint_dir:
            # train resumes from its own results dir by name
            raise SystemExit(
                "--checkpoint-dir is eval-side only (evaluate/sample/ood); "
                "train resumes from <results_dir>/<name>/checkpoints — use "
                "--set name=... / --set results_dir=...")
    if args.command == "sample" and args.visualize:
        # prior sampling's flags do nothing here: refuse rather than ignore
        default = vars(parser.parse_known_args(["sample"])[0])
        moved = ["--" + dest.replace("_", "-") for dest in (
            "prior", "temperature", "gmm_k", "flow_steps", "quality")
            if getattr(args, dest) != default[dest]]
        if moved:
            raise SystemExit(f"{', '.join(moved)} apply to prior sampling; "
                             "they have no effect with --visualize — run "
                             "`apv-torch sample` without it")
    if getattr(args, "distributed", False):
        # before anything touches the card
        from apv_tpu_torch.parallel.multihost import initialize_from_env
        if not initialize_from_env(device=args.device):
            raise SystemExit("--distributed set but APV_COORDINATOR unset")
    if args.debug_nans:
        import torch
        torch.autograd.set_detect_anomaly(True)
    import apv_tpu_torch as api

    dev = args.device
    if args.command == "train":
        try:
            state = api.train(args.preset, overrides=args.overrides,
                              resume=args.resume, max_steps=args.max_steps,
                              trace_dir=args.trace_dir,
                              overwrite=args.overwrite, device=dev)
        finally:
            if args.distributed:
                import torch.distributed as dist
                dist.destroy_process_group()
        print(f"trained to step {int(state.step)}")
    elif args.command == "evaluate":
        result = api.evaluate(args.preset, overrides=args.overrides,
                              checkpoint_dir=args.checkpoint_dir,
                              dataset=args.dataset, k=args.k,
                              prior=args.prior, gmm_k=args.gmm_k,
                              flow_steps=args.flow_steps, device=dev)
        print(json.dumps(result, indent=2))
    elif args.command == "sample" and args.visualize:
        api.visualize(args.preset, overrides=args.overrides,
                      checkpoint_dir=args.checkpoint_dir,
                      what=args.visualize, n=args.n, steps=args.steps,
                      seed=args.seed, mode=args.mode, out_path=args.out,
                      refine=args.refine, device=dev)
        print(f"wrote {args.visualize} grid")
    elif args.command == "sample":
        api.sample(args.preset, overrides=args.overrides,
                   checkpoint_dir=args.checkpoint_dir, n=args.n,
                   mode=args.mode, seed=args.seed, out_path=args.out,
                   quality_n=args.quality, refine=args.refine,
                   prior=args.prior, gmm_k=args.gmm_k,
                   flow_steps=args.flow_steps,
                   temperature=args.temperature, device=dev)
        print("wrote sample grid")
    elif args.command == "ood":
        result = api.ood_score(args.preset, overrides=args.overrides,
                               checkpoint_dir=args.checkpoint_dir,
                               seed=args.seed, both=args.both, device=dev)
        print(json.dumps(result, indent=2))
    elif args.command == "export":
        try:
            path = api.export_artifact(
                args.preset, overrides=args.overrides,
                checkpoint_dir=args.checkpoint_dir, what=args.what,
                out_path=args.out, quantize=args.quantize,
                refine=args.refine, prior=args.prior, gmm_k=args.gmm_k,
                flow_steps=args.flow_steps, temperature=args.temperature,
                device=dev)
        except ValueError as e:
            raise SystemExit(f"export: {e}") from e
        print(f"exported {args.what} to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
