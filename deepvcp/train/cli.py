"""Training CLI (flag parity with ref train.py:24-34 plus config overrides).

    python -m deepvcp.train -d modelnet -f full --root /path/to/data
    python -m deepvcp.train -d kitti --root /path/to/kitti
    python -m deepvcp.train -d synthetic --num-points 512 --epochs 2
"""

from __future__ import annotations

import argparse

from deepvcp.config import DeepVCPConfig, TrainConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train DeepVCP")
    # reference flags (train.py:24-34)
    p.add_argument("-d", "--dataset", default="modelnet",
                   choices=["modelnet", "kitti", "synthetic"],
                   help="dataset (modelnet, kitti, or synthetic)")
    p.add_argument("-f", "--full_dataset", default="full",
                   help="train on 'full' or 'partial' dataset")
    p.add_argument("-r", "--retrain_path", type=str, default=None,
                   help="checkpoint to warm-start from")
    p.add_argument("-m", "--model_path", type=str, default="final_model",
                   help="tag for the final checkpoint")
    # paths / config (the reference hard-codes these, train.py:52,57)
    p.add_argument("--root", type=str, default=None, help="dataset root dir")
    p.add_argument("--checkpoint-dir", type=str, default="checkpoints")
    p.add_argument("--metrics-path", type=str, default="metrics.jsonl")
    # hyper-parameters (ref train.py:38-42)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    # model constants (ref deepVCP.py:33,54,61,76-77)
    p.add_argument("--num-points", type=int, default=10000)
    p.add_argument("--num-keypoints", type=int, default=64)
    p.add_argument("--tiny", action="store_true",
                   help="use the tiny test topology (smoke runs)")
    p.add_argument("--eval-only", action="store_true",
                   help="load --retrain_path and evaluate the test split "
                        "(the working version of the reference's "
                        "model_eval.py)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in "
                        "--checkpoint-dir (elastic restart)")
    p.add_argument("--save-vis", type=str, default=None, metavar="DIR",
                   help="with --eval-only: save {i}_gt.npy/{i}_pred.npy "
                        "cloud pairs + vis.pcd to DIR (vis_utils.py parity)")
    p.add_argument("--recipe", default="reference",
                   choices=["reference", "residual"],
                   help="'reference' = exact reference training semantics "
                        "(GT warm start, rigid-fit-only loss, constant lr); "
                        "'residual' = the round-4 recipe: jittered warm "
                        "starts (so Registrar refine_iters contracts "
                        "instead of diverging), direct VCP L1 term, cosine "
                        "lr, saliency-weighted solves")
    p.add_argument("--init-rot-jitter-deg", type=float, default=None,
                   help="override the warm-start rotation jitter (residual "
                        "recipe defaults to 12)")
    p.add_argument("--init-trans-jitter", type=float, default=None,
                   help="override the warm-start translation jitter "
                        "(residual recipe defaults to 0.5)")
    p.add_argument("--keypoint-selection", default=None,
                   choices=["topk", "salient_fps"],
                   help="keypoint policy: topk (reference parity) or "
                        "salient_fps (spread-enforcing; the fix for "
                        "density-gradient lidar clouds)")
    return p


def configs_from_args(args) -> tuple[DeepVCPConfig, TrainConfig]:
    import dataclasses

    use_normal = args.dataset == "modelnet"
    if args.tiny:
        model_cfg = DeepVCPConfig.tiny(
            num_points=args.num_points, use_normal=use_normal
        )
    else:
        model_cfg = DeepVCPConfig(
            num_points=args.num_points,
            use_normal=use_normal,
            num_keypoints=args.num_keypoints,
        )
    if args.keypoint_selection is not None:
        model_cfg = dataclasses.replace(
            model_cfg, keypoint_selection=args.keypoint_selection
        )
    extra = {}
    if args.recipe == "residual":
        # the round-4 campaign recipe (scripts/campaign_r4_common.py);
        # total_steps for the cosine schedule is filled in by main()
        extra = dict(
            vcp_loss_weight=1.0,
            lr_schedule="cosine",
            warmup_steps=100,
            use_saliency_weights=True,
            init_translation="gt",
            init_rot_jitter_deg=12.0,
            init_trans_jitter=0.5,
        )
    if args.init_rot_jitter_deg is not None:
        extra["init_rot_jitter_deg"] = args.init_rot_jitter_deg
    if args.init_trans_jitter is not None:
        extra["init_trans_jitter"] = args.init_trans_jitter
    train_cfg = TrainConfig(
        num_epochs=args.epochs,
        batch_size=args.batch_size,
        learning_rate=args.lr,
        alpha=args.alpha,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        metrics_path=args.metrics_path,
        **extra,
    )
    return model_cfg, train_cfg


def make_dataset(args, model_cfg: DeepVCPConfig, split: str):
    from deepvcp.data import (
        KITTIDataset,
        ModelNet40Dataset,
        SyntheticDataset,
    )

    if args.dataset == "modelnet":
        if not args.root:
            raise SystemExit("--root is required for modelnet")
        return ModelNet40Dataset(
            args.root,
            split=split,
            full_dataset=args.full_dataset == "full",
            num_points=model_cfg.num_points,
            use_normal=model_cfg.use_normal,
        )
    if args.dataset == "kitti":
        if not args.root:
            raise SystemExit("--root is required for kitti")
        return KITTIDataset(
            args.root, split=split, num_points=model_cfg.num_points
        )
    return SyntheticDataset(
        num_clouds=16 if split == "train" else 4,
        num_points=model_cfg.num_points,
        use_normal=model_cfg.use_normal,
        seed=0 if split == "train" else 1,
    )


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    model_cfg, train_cfg = configs_from_args(args)

    from deepvcp.data import batch_iterator
    from deepvcp.train.trainer import Trainer
    from deepvcp.utils.cache import enable_compile_cache

    enable_compile_cache()
    train_data = make_dataset(args, model_cfg, "train")
    test_data = make_dataset(args, model_cfg, "test")
    print(
        f"Train dataset size: {len(train_data)}  "
        f"Test dataset size: {len(test_data)}"
    )

    if train_cfg.lr_schedule == "cosine" and train_cfg.total_steps == 0:
        import dataclasses

        steps_per_epoch = max(
            len(train_data) // train_cfg.batch_size, 1
        )
        train_cfg = dataclasses.replace(
            train_cfg,
            total_steps=train_cfg.num_epochs * steps_per_epoch,
        )

    trainer = Trainer(model_cfg, train_cfg)
    sample = next(
        batch_iterator(train_data, train_cfg.batch_size, epoch=0,
                       seed=train_cfg.seed)
    )
    trainer.setup(sample, retrain_path=args.retrain_path)

    if args.eval_only:
        out = trainer.evaluate(
            batch_iterator(test_data, train_cfg.batch_size, epoch=0,
                           seed=train_cfg.seed + 1, shuffle=False)
        )
        print("eval:", out)
        if args.save_vis:
            import numpy as np

            from deepvcp.ops import apply_rigid
            from deepvcp.registration import Registrar
            from deepvcp.utils.vis import draw, save_cloud_pair

            reg = Registrar(
                model_cfg,
                {"params": trainer.state.params,
                 "batch_stats": trainer.state.batch_stats},
            )
            import jax.numpy as jnp

            for n_batch, (src, tgt, R_gt, t_gt) in enumerate(
                batch_iterator(test_data, train_cfg.batch_size, epoch=0,
                               seed=train_cfg.seed + 1, shuffle=False)
            ):
                r = reg(jnp.asarray(src), jnp.asarray(tgt))
                pred = np.asarray(
                    apply_rigid(jnp.asarray(src[..., :3]), r.R, r.t)
                )
                for b in range(src.shape[0]):
                    save_cloud_pair(
                        args.save_vis,
                        n_batch * train_cfg.batch_size + b,
                        tgt[b, :, :3],
                        pred[b],
                    )
            import os

            draw(
                [tgt[0, :, :3], pred[0]],
                os.path.join(args.save_vis, "vis.pcd"),
            )
            print(f"vis saved to {args.save_vis}")
        return

    def train_batches(epoch):
        return batch_iterator(
            train_data, train_cfg.batch_size, epoch=epoch, seed=train_cfg.seed
        )

    def eval_batches(epoch):
        return batch_iterator(
            test_data, train_cfg.batch_size, epoch=epoch,
            seed=train_cfg.seed + 1, shuffle=False,
        )

    trainer.fit(train_batches, eval_batches, resume=args.resume)
    path = trainer.save_checkpoint(args.model_path)
    print(f"Finished Training; final checkpoint at {path}")


if __name__ == "__main__":
    main()
