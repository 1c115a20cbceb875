"""Restartable multi-process launcher on torch.distributed.

Port of montecarlo_pathtracing_tpu/parallel/launcher.py. The reference is
a single-process GL app with no failure handling beyond shader-compile
errors (SURVEY.md §5). For renders across processes (one per card, or
several hosts) the port provides: process-group initialization from
arguments or torchrun's environment, a render loop that checkpoints the
accumulation state every K passes, and crash-resume: a relaunched
process picks up at its last checkpointed pass, so losing a process
costs at most K passes of its work.

Launch (per process):
  python -m montecarlo_pathtracing_tpu_torch render --distributed \\
      --coordinator host0:8476 --num-processes 4 --process-id $ID \\
      --checkpoint state.npz --checkpoint-every 64 ...

The accumulators are gathered over gloo from host copies (as JAX's
process_allgather does), once per render, so the same code runs on the
CPU and on the cards; NCCL is not used.

Determinism makes this safe: per-pixel seeds are pure functions of
(uv, pass), so re-rendering a partially completed pass range after a
restart yields bit-identical contributions.
"""
from __future__ import annotations

import datetime
import os
import sys

import torch
import torch.distributed as dist

# a lost peer fails the survivors' collectives after this long, instead
# of hanging them
TIMEOUT_S = 120


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """Join the process group (gloo, `tcp://<coordinator>`). Returns this
    process's rank.

    The arguments default to torchrun's environment, which takes the
    place of JAX's: MASTER_ADDR:MASTER_PORT for JAX_COORDINATOR_ADDRESS,
    WORLD_SIZE for JAX_NUM_PROCESSES, RANK for JAX_PROCESS_ID. Does
    nothing when the group is already initialized or when there is one
    process. Where there is a card, the process takes card LOCAL_RANK
    (default: its rank) modulo the card count as its current device and
    prints it: on a one-card host every process shares cuda:0."""
    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if dist.is_initialized():
        return dist.get_rank()
    if num_processes <= 1:
        return process_id
    if not coordinator:
        raise ValueError("a distributed render needs the coordinator's "
                         "host:port (--coordinator or MASTER_ADDR)")
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", process_id))
        card = local % torch.cuda.device_count()
        torch.cuda.set_device(card)
        print(f"process {process_id} of {num_processes}: cuda:{card} "
              f"({torch.cuda.get_device_name(card)})", file=sys.stderr,
              flush=True)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return process_id


def rank_and_size() -> tuple:
    """(this process's rank, the process count): (0, 1) outside a group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_checkpoint_path(checkpoint: str, pid: int) -> str:
    """Per-process checkpoint name: rank tag before the extension."""
    root, ext = os.path.splitext(checkpoint)
    return f"{root}.p{pid}{ext or '.npz'}"


def run_multihost_render(renderer, spp: int, checkpoint: str | None = None,
                         checkpoint_every: int = 64):
    """Sample-axis data parallelism across PROCESSES: process k of P
    renders the contiguous pass block [k*spp//P, (k+1)*spp//P) into its
    own accumulator, checkpointing every checkpoint_every passes; the
    final image is the sum of the accumulators, in process-ascending
    order, / spp (the average.frag analog across processes). Per-pixel
    seeds are pure functions of (uv, pass) (ops/rng.srand_soa), so the
    partition is invisible to the result and a crashed process resumes
    from its own checkpoint losing at most checkpoint_every passes.

    Each process checkpoints to '<checkpoint-root>.p<k>.npz' (np.savez
    appends .npz to suffix-less paths, so the rank tag goes before the
    extension). Returns the resolved [H, W, 3] image (every process
    returns the same array)."""
    pid, nproc = rank_and_size()
    base = pid * spp // nproc
    end = (pid + 1) * spp // nproc
    ckpt = process_checkpoint_path(checkpoint, pid) if checkpoint else None
    if ckpt and os.path.exists(ckpt):
        renderer.load_checkpoint(ckpt)
    else:
        renderer.nb_passes = base          # pass-indexed seeds start here
    while renderer.nb_passes < end:
        target = min(end, renderer.nb_passes + max(1, checkpoint_every))
        renderer.run(target)
        if ckpt:
            renderer.save_checkpoint(ckpt)
    acc = renderer.accumulator()
    if nproc > 1:
        mine = torch.from_numpy(acc)
        parts = [torch.empty_like(mine) for _ in range(nproc)]
        dist.all_gather(parts, mine)
        acc = parts[0].numpy()
        for part in parts[1:]:          # process-ascending order
            acc = acc + part.numpy()
    # resolve through the renderer, so the block32 pixel permutation is
    # inverted exactly as in Renderer.image()
    return renderer.resolve(acc, passes=spp)


def run_distributed_render(renderer, spp: int, checkpoint: str | None,
                           checkpoint_every: int = 64,
                           is_coordinator: bool | None = None):
    """Progressive render with periodic checkpointing; resumes from
    `checkpoint` if present. Only the coordinator writes checkpoints
    (single writer: every process renders the same passes)."""
    if is_coordinator is None:
        is_coordinator = rank_and_size()[0] == 0
    if checkpoint and os.path.exists(checkpoint):
        renderer.load_checkpoint(checkpoint)
    while renderer.nb_passes < spp:
        target = min(spp, renderer.nb_passes + max(1, checkpoint_every))
        renderer.run(target)
        if checkpoint and is_coordinator:
            renderer.save_checkpoint(checkpoint)
    return renderer.image()
