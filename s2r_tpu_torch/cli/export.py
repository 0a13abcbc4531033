"""Convert a checkpoint to a deployable artifact (s2r_tpu/cli/export.py).

The checkpoint may be the port's, the JAX package's msgpack ``.ckpt`` or a
reference ``.pth``/``.pth.tar`` (train/trainer.py ``resume_into``).

--format torch (default): a reference-format .pth.tar.
    python -m s2r_tpu_torch.cli.export --resume run/.../model_best.ckpt \\
        --out exported.pth.tar [--schema single|four] [--method ...]
  'single' is train_adapt.py's layout; 'four' is train.py's, with the
  domain classifier of a feature_adapt / source_only checkpoint.

--format servable: the port's servable (io/serving.py): the weights and
  the serving options, which cli/infer.py serves on the card.
    python -m s2r_tpu_torch.cli.export --resume .../model_best.ckpt \\
        --format servable --out model.s2rt \\
        [--serve-shape 8 1024 2048] [--serve-input rgb8] \\
        [--serve-quant decoder-int8 --calib-batches 4] [--serve-batch-poly]
  ``--serve-quant decoder-int8`` calibrates io/quant.py's scales on
  ``--calib-batches`` val batches of the configured dataset.
  ``--serve-platforms`` takes 'cuda' and 'cpu' and records them: the
  artifact holds weights, not compiled code.  ``--serve-split-concat``
  raises (ROADMAP A.5).

``--backbone`` names the checkpoint's backbone (a JAX or reference file
does not record it); the servable's meta records it, and cli/infer.py
rebuilds that model.  The checkpoint is read with ft off, so the
artifact's epoch is the checkpoint's own.  Runs on the card;
``S2R_PLATFORM=cpu`` selects the CPU.
"""

from __future__ import annotations

import argparse
import itertools

from s2r_tpu_torch.config import add_common_flags, config_from_args
from s2r_tpu_torch.core.device import device_from_env


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="export an s2r_tpu_torch checkpoint to the reference "
                    "torch format or a servable")
    add_common_flags(parser)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--format", type=str, default="torch",
                        choices=["torch", "servable"])
    parser.add_argument("--schema", type=str, default="single",
                        choices=["single", "four"])
    parser.add_argument("--method", type=str, default="output_adapt",
                        choices=["output_adapt", "feature_adapt",
                                 "source_only"])
    parser.add_argument("--serve-shape", type=int, nargs=3,
                        default=[1, 1024, 2048], metavar=("N", "H", "W"),
                        help="servable input shape (default full-res "
                             "Cityscapes eval, batch 1)")
    parser.add_argument("--serve-output", type=str, default="labels",
                        choices=["labels", "logits", "probs"])
    parser.add_argument("--serve-input", type=str, default="normalized",
                        choices=["normalized", "rgb8"])
    parser.add_argument("--serve-argmax", type=str, default="full",
                        choices=["full", "decoder"],
                        help="labels output only: 'full' = upsample the "
                             "logits, then argmax (the eval path); "
                             "'decoder' = argmax at stride 4, then "
                             "nearest-upsample the labels")
    parser.add_argument("--serve-split-concat", action="store_true",
                        dest="serve_split_concat",
                        help="not ported (ROADMAP A.5)")
    parser.add_argument("--serve-label-dtype", type=str, default="int32",
                        choices=["int32", "uint8"],
                        help="labels output only")
    parser.add_argument("--serve-quant", type=str, default="none",
                        choices=["none", "decoder-int8"],
                        help="'decoder-int8': the decoder head's two 3x3 "
                             "convs in int8 with folded BatchNorm "
                             "(io/quant.py); not exact")
    parser.add_argument("--calib-batches", type=int, default=4,
                        help="val batches used to calibrate int8 activation "
                             "scales (--serve-quant decoder-int8 only)")
    parser.add_argument("--serve-pad-batch", type=int, default=None,
                        metavar="P",
                        help="zero-pad the input batch to P and slice the "
                             "output back")
    parser.add_argument("--serve-batch-poly", action="store_true",
                        help="accept any batch size N")
    parser.add_argument("--serve-platforms", type=str, nargs="+",
                        default=None,
                        help="'cuda' and/or 'cpu', recorded in the meta "
                             "(default: the device exported on)")
    args = parser.parse_args(argv)
    if args.serve_argmax == "decoder" and args.serve_output != "labels":
        parser.error("--serve-argmax decoder requires --serve-output labels")
    if args.serve_label_dtype != "int32" and args.serve_output != "labels":
        parser.error("--serve-label-dtype requires --serve-output labels")
    if args.serve_split_concat:
        raise NotImplementedError("s2r_tpu_torch: --serve-split-concat is "
                                  "not ported (ROADMAP A.5)")
    cfg = config_from_args(args)
    if not cfg.resume:
        parser.error("--resume <checkpoint> is required")

    from s2r_tpu_torch.train.setup import build_method
    from s2r_tpu_torch.train.trainer import resume_into

    device = device_from_env()
    m = build_method(cfg, iters_per_epoch=1, method=args.method,
                     device=device)
    state = m.init_state()
    # ft off (the resume default would keep epoch 0): the exported 'epoch'
    # is the checkpoint's own
    epoch, best_pred = resume_into(state, cfg.resume, False)
    model = m.eval_variables(state)

    if args.format == "servable":
        from s2r_tpu_torch.io.serving import export_servable

        n, h, w = args.serve_shape
        quant = args.serve_quant.replace("-", "_")
        quant_scales = None
        if quant != "none":
            from s2r_tpu_torch.data.device_aug import normalize_u8_batch
            from s2r_tpu_torch.data.loader import make_data_loader
            from s2r_tpu_torch.io.quant import calibrate_decoder_int8
            from s2r_tpu_torch.parallel.feed import prefetch_to_device

            _, val_loader, _, _ = make_data_loader(cfg)
            batches = [normalize_u8_batch(b)["image"]
                       for b in itertools.islice(prefetch_to_device(
                           val_loader, device), args.calib_batches)]
            quant_scales = calibrate_decoder_int8(model, batches)
            print(f"calibrated int8 scales on {len(batches)} val batches: "
                  f"{quant_scales}")
        info = export_servable(
            model, (n, h, w, 3), args.out, output=args.serve_output,
            input=args.serve_input, argmax_res=args.serve_argmax,
            label_dtype=args.serve_label_dtype, quant=quant,
            quant_scales=quant_scales, pad_batch_to=args.serve_pad_batch,
            platforms=args.serve_platforms,
            batch_polymorphic=args.serve_batch_poly,
            meta={"epoch": int(epoch), "best_pred": float(best_pred)})
        q = f", quant {info['quant']}" if info["quant"] != "none" else ""
        print(f"exported servable ({info['output']}, {info['input']}, "
              f"shape {info['input_shape']}, platforms "
              f"{info['platforms']}{q}) to {args.out}")
        return info

    from s2r_tpu_torch.io.torch_export import save_reference_checkpoint

    # feature-method states carry the domain classifier in D
    domain = (state.D if args.schema == "four" and m.name != "output_adapt"
              else None)
    save_reference_checkpoint(args.out, model, domain, epoch=epoch,
                              best_pred=best_pred, schema=args.schema,
                              backbone=cfg.backbone)
    print(f"exported {args.schema}-schema checkpoint to {args.out}")
    return {"schema": args.schema, "epoch": int(epoch),
            "best_pred": float(best_pred)}


if __name__ == "__main__":
    main()
