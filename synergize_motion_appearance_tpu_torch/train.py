"""Training entry point of the port (counterpart of the JAX package's
train.py; the reference's basicsr/train.py:116-227).

    python -m synergize_motion_appearance_tpu_torch.train \
        -opt options/train.yml

``main`` parses the arguments and the option file; ``run(opt)`` trains
from an option dict, so a caller without a YAML reader passes one built
in Python (``configs.py``) through ``utils.options.derive_paths``.
Batches from the frame-folder dataset (threaded ``BatchLoader``) or from a
native frame cache (``datasets.train.native_cache``), ``training.Trainer``
steps, resume from ``path.resume_state`` or the newest checkpoint,
``print_freq`` logging with the step's ``time`` and ``data_time`` (the
wait for its batch), ``save_checkpoint_freq`` checkpoints, and in-training
validation of the EMA generator.

Several GPUs, one process each (``--launcher pytorch`` under ``torchrun``,
or ``--launcher slurm`` under ``srun``), as the JAX entry point runs its
data mesh: each rank trains on ``cuda:<local rank>`` with
``batch_size_per_gpu`` samples of a global batch of that times the world
size, from its own share of the sampler (or the native cache seeded with
``seed + rank``); the step averages the gradients over the ranks
(``training.trainer``). Rank 0 alone writes the log file, TensorBoard and
the checkpoints, and runs validation.

    torchrun --nproc_per_node 2 \
        -m synergize_motion_appearance_tpu_torch.train \
        -opt options/train_v5e2.yml --launcher pytorch
"""
from __future__ import annotations

import argparse
import time
from os import path as osp
from typing import Any, Dict, List


def main(argv=None) -> List[Dict[str, Any]]:
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True,
                        help="Path to option YAML file.")
    parser.add_argument("--launcher", choices=["none", "pytorch", "slurm"],
                        default="none",
                        help="multi-process launcher: 'pytorch' reads the "
                             "torchrun variables, 'slurm' derives them like "
                             "the reference's dist_util.py:28-57")
    parser.add_argument("--steps", type=int, default=None,
                        help="override total_iter (smoke runs)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default cuda)")
    args = parser.parse_args(argv)

    from .utils.options import parse

    opt = parse(args.opt, is_train=True)
    if args.steps is not None:
        opt["train"]["total_iter"] = args.steps
    return run(opt, device=args.device, launcher=args.launcher)


def run(opt: Dict[str, Any], device="cuda", launcher: str = "none"
        ) -> List[Dict[str, Any]]:
    """Train from ``opt`` (with its paths derived) on ``device`` up to
    ``train.total_iter``; returns the records that were logged (every
    ``print_freq`` steps): iter, epoch, lrs, time, data_time and the
    step's logs as floats (the global means). With a ``launcher`` other
    than 'none' it joins the process group (``parallel.init_distributed``:
    NCCL for a card, gloo for the CPU), trains on ``cuda:<local rank>``
    when ``device`` is 'cuda', and leaves the group at the end."""
    from .parallel import in_process_group, init_distributed

    info = init_distributed(launcher, device=device)
    joined = launcher != "none" and in_process_group()
    if joined and str(device) == "cuda":
        device = f"cuda:{info.local_rank}"
    try:
        return _train(opt, device, info.rank, info.world_size)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(opt, device, rank, world):
    """``run``'s body, as rank ``rank`` of ``world``."""
    from .data import BatchLoader, EnlargedSampler, build_dataset, \
        infinite_batches
    from .parallel import barrier
    from .training import (Trainer, batch_to_device, latest_checkpoint,
                           restore_checkpoint, save_checkpoint,
                           step_generator)
    from .utils.logger import (MessageLogger, get_env_info, get_root_logger,
                               init_tb_logger, init_wandb_logger)
    from .utils.misc import set_random_seed, sizeof_fmt
    from .utils.options import dict2str, make_exp_dirs

    make_exp_dirs(opt)
    logger = get_root_logger(
        log_file=osp.join(opt["path"]["log"], "train.log"))
    logger.info(get_env_info())
    logger.info(dict2str(opt))
    tb_logger = None
    if opt.get("logger", {}).get("use_tb_logger") and rank == 0:
        init_wandb_logger(opt)
        tb_logger = init_tb_logger(osp.join(opt["path"]["log"], "tb_logger"))

    seed = opt.get("manual_seed", 0)
    # the data's draws differ by rank; the weights seed themselves from
    # `seed` (weights.seeded_train_nets), the same on every rank
    set_random_seed(seed + rank)

    # ---- data ----
    ds_opt = opt["datasets"]["train"]
    ds_opt["is_train"] = True
    batch_size = int(ds_opt.get("batch_size_per_gpu", 4))  # per rank
    if ds_opt.get("native_cache"):
        batches, n_videos = _native_batches(ds_opt, batch_size, seed, logger,
                                            rank, world)
    else:
        dataset = build_dataset(ds_opt)
        n_videos = len(dataset)
        sampler = EnlargedSampler(
            n_videos, world, rank,
            ratio=int(ds_opt.get("dataset_enlarge_ratio", 1)))
        loader = BatchLoader(dataset, batch_size, sampler,
                             num_workers=int(ds_opt.get("num_worker_per_gpu",
                                                        4)))
        batches = infinite_batches(loader)
    logger.info(f"Dataset {ds_opt.get('name')}: {n_videos} videos, "
                f"{batch_size} samples per step on each of {world} ranks.")

    # ---- model / state ----
    trainer = Trainer(opt, device=device, seed=seed)
    start_epoch, start_iter = 0, 0
    ckpt_dir = opt["path"]["training_states"]
    resume = opt["path"].get("resume_state") or latest_checkpoint(ckpt_dir)
    if resume:
        start_epoch = restore_checkpoint(resume, trainer)
        trainer.broadcast_state()
        start_iter = trainer.state.step
        logger.info(f"Resumed from {resume} @ iter {start_iter}")

    total_iter = int(opt["train"]["total_iter"])
    msg_logger = MessageLogger(opt, start_iter, tb_logger)
    print_freq = int(opt.get("logger", {}).get("print_freq", 100))
    save_freq = int(opt.get("logger", {}).get("save_checkpoint_freq", 5e3))
    val_state = _build_val_state(opt)

    logger.info(f"Start training from epoch {start_epoch}, iter "
                f"{start_iter}")
    records = []
    data_t = iter_t = time.time()
    current_iter = start_iter
    while current_iter < total_iter:
        epoch, batch = next(batches)
        batch = batch_to_device(batch, trainer.device)
        data_time = time.time() - data_t

        logs = trainer.train_step(
            batch, generator=step_generator(seed, current_iter,
                                            trainer.device))
        current_iter += 1

        if current_iter % print_freq == 0:
            record = {"iter": current_iter, "epoch": epoch,
                      "lrs": [trainer.lr_g(current_iter)],
                      "time": time.time() - iter_t, "data_time": data_time,
                      **{k: float(v) for k, v in logs.items()}}
            records.append(record)
            msg_logger(record)
        iter_t = time.time()

        if current_iter % save_freq == 0 or current_iter == total_iter:
            path = save_checkpoint(ckpt_dir, trainer, epoch)
            if path:
                logger.info(f"Saved checkpoint {path} @ iter {current_iter} "
                            f"({sizeof_fmt(osp.getsize(path))})")
            barrier()

        if (val_state is not None and rank == 0
                and current_iter % val_state["freq"] == 0):
            _run_validation(opt, trainer, val_state, current_iter,
                            tb_logger, logger)
        data_t = time.time()

    if tb_logger is not None:
        tb_logger.close()
    logger.info("Training done.")
    return records


def _native_batches(ds_opt, batch_size, seed, logger, rank=0, world=1):
    """(epoch, batch) stream from the native frame cache, the counterpart
    of ``infinite_batches(BatchLoader)``; builds the cache from the frame
    tree under ``root_dir`` when it does not exist (rank 0 builds it, the
    others wait). Returns it and the cache's number of videos. Each rank's
    loader is seeded with ``seed + rank``. Epochs count consumed global
    samples against the sampler's virtual length (videos x
    dataset_enlarge_ratio)."""
    from .parallel import barrier
    from .data.native_loader import NativeFrameCacheLoader, \
        cache_from_frame_tree

    cache = ds_opt["native_cache"]
    if not osp.exists(cache) and rank == 0:
        root = osp.join(ds_opt["root_dir"], "train")
        if not osp.isdir(root):
            root = ds_opt["root_dir"]
        logger.info(f"Building frame cache {cache} from {root} ...")
        cache_from_frame_tree(root, cache, int(ds_opt.get("gt_size", 256)))
    barrier()
    loader = NativeFrameCacheLoader(
        cache, batch_size,
        num_workers=int(ds_opt.get("num_worker_per_gpu", 4)),
        seed=seed + rank,
        hflip=bool(ds_opt.get("use_hflip", True)),
        time_flip=bool(ds_opt.get("use_time_flip", True)))
    ratio = int(ds_opt.get("dataset_enlarge_ratio", 1))
    epoch_len = max(loader.num_videos * ratio // (batch_size * world), 1)

    def gen():
        step = 0
        try:
            while True:
                yield step // epoch_len, loader.next()
                step += 1
        finally:
            loader.close()

    return gen(), loader.num_videos


def _build_val_state(opt):
    """What in-training validation needs (train.py:209-211), or None when
    there is no val dataset or its frequency is off."""
    val_opt = opt.get("val") or {}
    ds_opt = (opt.get("datasets") or {}).get("val")
    freq = float(val_opt.get("val_freq", 0) or 0)
    total = float(opt.get("train", {}).get("total_iter", 0))
    if not ds_opt or freq <= 0 or freq > total:
        return None
    from .data import build_dataset

    ds_opt = dict(ds_opt)
    ds_opt["is_train"] = False
    return {"freq": int(freq), "dataset": build_dataset(ds_opt),
            "metrics": val_opt.get("metrics") or {},
            "max_items": int(val_opt.get("max_items", 32))}


PER_IMAGE_METRICS = ("psnr", "ssim", "l1")


def _run_validation(opt, trainer, val_state, current_iter, tb_logger,
                    logger):
    """The EMA generator over the val set (nondist_validation,
    appmotioncomp_model.py:463-570): PSNR, SSIM and L1 per image, averaged;
    every other metric scores the saved result/gt PNG directories on the
    trainer's device, and one that lacks its weights or its package is
    logged and skipped (train.py:301-303)."""
    import torch

    from .metrics import calculate_metric
    from .utils.img_util import arr2img, imwrite

    dataset = val_state["dataset"]
    metrics = val_state["metrics"]
    dir_metrics = {m: o for m, o in metrics.items()
                   if m not in PER_IMAGE_METRICS}
    results = {m: 0.0 for m in metrics}
    n = min(len(dataset), val_state["max_items"])
    vis_root = osp.join(opt["path"].get("visualization",
                                        opt["path"]["log"]),
                        f"val_{current_iter}")
    res_dir, gt_dir = osp.join(vis_root, "result"), osp.join(vis_root, "gt")
    for idx in range(n):
        item = dataset[idx]
        pair = {k: torch.from_numpy(item[k][None]) for k in ("source",
                                                             "driving")}
        pair = {k: v.to(trainer.device).permute(0, 3, 1, 2)
                for k, v in pair.items()}
        out = trainer.ema_forward(pair["source"], pair["driving"])
        result_img = arr2img(out.permute(0, 2, 3, 1).float().cpu().numpy(),
                             rgb2bgr=True)
        gt_img = arr2img(item["driving"], rgb2bgr=True)
        if dir_metrics:
            imwrite(result_img, osp.join(res_dir, f"{idx:05d}.png"))
            imwrite(gt_img, osp.join(gt_dir, f"{idx:05d}.png"))
        for mname, mopt in metrics.items():
            if mname in PER_IMAGE_METRICS:
                results[mname] += calculate_metric(
                    dict(img1=result_img, img2=gt_img), mopt)
    for mname, mopt in dir_metrics.items():
        mopt = dict(mopt)
        mopt.setdefault("type", f"calculate_{mname}")
        if mname == "fid":
            data = dict(paths=[gt_dir, res_dir])
        elif mname == "lpips":
            data = dict(path1=res_dir, path2=gt_dir)
        else:
            data = dict(path_gt=gt_dir, path_generated=res_dir)
        try:
            results[mname] = calculate_metric(
                dict(data, device=trainer.device), mopt)
        except RuntimeError as e:  # weights or a package absent
            logger.warning(f"Validation metric {mname} skipped: {e}")
            results.pop(mname)
    for mname in results:
        if mname in PER_IMAGE_METRICS:
            results[mname] /= max(n, 1)
        logger.info(f"Validation @ {current_iter} # {mname}: "
                    f"{results[mname]:.4f}")
        if tb_logger is not None:
            tb_logger.add_scalar(f"metrics/{mname}", results[mname],
                                 current_iter)
    return results


if __name__ == "__main__":
    main()
