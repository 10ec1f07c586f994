"""How far the two-rank tiny step lies from the one-process step, over
many draws: chip_smoke.py's split-batch parity (tiny_train in float32, a
global batch of DP_GLOBAL_TINY split over two gloo ranks on one device,
each step from the one-process run's saved state) repeated from states
perturbed by 1e-6 relative (draw 0 unperturbed), with the one-process
step repeated from the same state beside it (the device's own spread).

For every draw and step it prints, by network, the relative 2-norm gap of
the gradients, the share of updated entries within 1e-6 and what misses
the bounds (chip_smoke.gradient_gaps, assert_updates_close,
bounds_missed), and ends with one JSON line of the extremes and of the
draws that the distributed phase would refuse.

    python3 chip_dp_spread.py [--draws N] [--cpu]
"""
import argparse
import json
import os
import shutil
import sys
import time

import torch

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
PERTURB = 1e-6  # relative, on G's and M's weights


def tiny_trainer(device, seed):
    from synergize_motion_appearance_tpu_torch import configs
    from synergize_motion_appearance_tpu_torch.training import Trainer

    cfg = configs.get("tiny_train")
    cfg["train"]["net_d_start_iter"] = 1
    return Trainer(cfg, device=device, seed=seed)


def tiny_batch(device, seed):
    return {k: v.to(device) for k, v in cs.smooth_train_batch(
        torch, 64, seed + 60, n=cs.DP_GLOBAL_TINY).items()}


def split_rank(rank, world, port, device, work, seed):
    """One rank (spawned): the tiny step on its half of the batch from each
    saved state. Writes <work>/rank<r>.pt."""
    sys.path.insert(0, ROOT)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if device == "cpu":
        torch.set_num_threads(2)
    from synergize_motion_appearance_tpu_torch.parallel import (
        init_distributed, shard_batch,
    )
    from synergize_motion_appearance_tpu_torch.training import (
        restore_checkpoint, step_generator,
    )

    if device != "cpu":
        torch.cuda.set_device(device)
    init_distributed("pytorch", backend="gloo", device=device,
                     environ=cs.rank_env(rank, world, port))
    tr = tiny_trainer(device, seed + 1)
    batch = shard_batch(tiny_batch(device, seed))
    out = []
    for i in range(cs.DP_TINY_STEPS):
        restore_checkpoint(os.path.join(work, "states", f"iter_{i}"), tr)
        tr.broadcast_state()
        tr.train_step(batch, generator=step_generator(seed, i, device))
        out.append(cs.train_state(tr))
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


def whole_steps(device, seed, work, draw):
    """The one-process run (perturbed unless draw 0), its state saved
    before each step; then the step again from each saved state."""
    from synergize_motion_appearance_tpu_torch.training import (
        restore_checkpoint, save_checkpoint, step_generator,
    )

    ref = tiny_trainer(device, seed)
    if draw:
        gen = torch.Generator().manual_seed(draw)
        with torch.no_grad():
            for net in (ref.net_g, ref.motion_estimator):
                for p in net.parameters():
                    p.mul_(1 + PERTURB * torch.randn(
                        p.shape, generator=gen).to(p.device))
    batch = tiny_batch(device, seed)
    before, after, lrs = [], [], []
    for i in range(cs.DP_TINY_STEPS):
        save_checkpoint(os.path.join(work, "states"), ref)
        before.append(cs.train_state(ref))
        lrs.append(cs.lr_of(ref, i))
        ref.train_step(batch, generator=step_generator(seed, i, device))
        after.append(cs.train_state(ref))
    again = tiny_trainer(device, seed + 1)
    repeat = []
    for i in range(cs.DP_TINY_STEPS):
        restore_checkpoint(os.path.join(work, "states", f"iter_{i}"), again)
        again.train_step(batch, generator=step_generator(seed, i, device))
        repeat.append(cs.train_state(again))
    return before, after, repeat, lrs


def gaps_and_shares(before, after, other, lr, betas):
    grads, gaps = cs.gradient_gaps(before, after, other, betas)
    shares = {}
    cs.assert_updates_close(torch, after, other, grads, lr, min_share=None,
                            shares=shares)
    return ({net: gap["rel_norm"] for net, gap in gaps.items()}, shares,
            cs.bounds_missed(gaps, shares))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", type=int, default=8)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda:0"
    if args.cpu:
        torch.set_num_threads(2)  # as each rank: the sums' order is fixed
    else:
        assert torch.cuda.is_available(), "no CUDA device"
        from synergize_motion_appearance_tpu_torch.ops import cuda_build

        print(cs.card_line(), flush=True)
        cuda_build.build("fused_attention_packed", "fused_attention_wgmma",
                         "conv3x3")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    seed, betas = 0, (0.9, 0.99)
    base = os.path.join(ROOT, "build", "chip_dp_spread")
    shutil.rmtree(base, ignore_errors=True)
    rows, t0 = [], time.perf_counter()
    for draw in range(args.draws):
        work = os.path.join(base, str(draw))
        os.makedirs(work)
        before, after, repeat, lrs = whole_steps(device, seed, work, draw)
        cs.run_ranks(split_rank, 2, (cs.free_port(), device, work, seed),
                     cs.RANK_TIMEOUT)
        split = torch.load(os.path.join(work, "rank0.pt"), weights_only=False)
        shutil.rmtree(work)
        for i in range(cs.DP_TINY_STEPS):
            row = {"draw": draw, "step": i}
            for name, other in (("split", split[i]), ("repeat", repeat[i])):
                (row[name + "_rel_norm"], row[name + "_share"],
                 row[name + "_missed"]) = gaps_and_shares(
                    before[i], after[i], other, lrs[i], betas)
            rows.append(row)
            print(json.dumps(row), flush=True)
    shutil.rmtree(base, ignore_errors=True)
    summary = {"draws": args.draws, "steps": len(rows),
               "seconds": time.perf_counter() - t0}
    for name in ("split", "repeat"):
        draws = [[r for r in rows if r["draw"] == d]
                 for d in range(args.draws)]
        summary[name + "_steps_off_bounds"] = sum(
            bool(r[name + "_missed"]) for r in rows)
        # draws that chip_smoke's distributed phase would refuse: a
        # network or group off the bounds at every step, or a gap past
        # DP_GROSS_GAP (the nu gaps, which follow the gradient's, are
        # not in the rows)
        summary[name + "_draws_refused"] = sum(
            any(all(k in r[name + "_missed"] for r in draw
                    if k in r[name + "_share"])
                for k in draw[-1][name + "_share"])
            or any(v > cs.DP_GROSS_GAP for r in draw
                   for v in r[name + "_rel_norm"].values())
            for draw in draws)
    for name in ("split", "repeat"):
        for key, pick in (("_rel_norm", max), ("_share", min)):
            nets = sorted({n for r in rows for n in r[name + key]})
            summary[name + key] = {n: pick(r[name + key][n] for r in rows
                                           if n in r[name + key])
                                   for n in nets}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
