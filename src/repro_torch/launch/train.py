"""Training launcher of the port (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --smoke --steps 50 --ckpt-dir /tmp/run0 [--device cpu]

Trains from float32 masters (the port's seeded ``lm.init``) on the
synthetic token stream, AdamW with warmup and cosine decay, and saves a
checkpoint every ``--ckpt-every`` steps and at the end. Restart the same
command after a failure and it resumes from the latest intact
checkpoint. Runs on the card unless ``--device cpu`` is given; one
device: a ``--mesh`` other than 1x1 and ``--force-devices`` wait for the
sharding port (ROADMAP queue 1 item 11). ``--ckpt-dir`` defaults to
``repro_train`` under the temporary directory (``TMPDIR``).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.synthetic import DataConfig, SyntheticLM, torch_batch
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.training.step import TrainState, make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL, e.g. 4x2")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_train"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--remat", default="none", choices=["none", "dots",
                                                        "full"])
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "topk", "int8"])
    ap.add_argument("--force-devices", type=int, default=0,
                    help="force N host devices (not ported)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def train_config(args) -> TrainConfig:
    """The run's TrainConfig: warmup over the first tenth of the steps,
    cosine decay to the last."""
    return TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                       total_steps=args.steps, microbatch=args.microbatch,
                       remat=args.remat,
                       grad_compression=args.grad_compression)


def data_config(cfg: ModelConfig, args) -> DataConfig:
    return DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                      global_batch=args.global_batch, seed=7,
                      n_states=32, temperature=0.22)


def main(argv=None):
    args = parse_args(argv)
    dshape = tuple(int(x) for x in args.mesh.split("x"))
    if dshape != (1, 1) or args.force_devices:
        raise NotImplementedError(
            "--mesh other than 1x1 and --force-devices need the sharding "
            "port (ROADMAP queue 1 item 11); the port trains on one device")
    device = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    tcfg = train_config(args)
    print(f"arch={cfg.arch} mesh={dshape} devices=1 steps={args.steps}")
    data = SyntheticLM(data_config(cfg, args))

    params = lm.init(cfg, seed=tcfg.seed, device=device,
                     dtype=cfg.param_dtype)
    state = TrainState(params, adamw.init_state(params))
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    start, state = ckpt.restore_latest(state)
    start = start or 0
    if start:
        print(f"resumed from checkpoint step {start}")

    step_fn = make_train_step(cfg, tcfg)
    t0 = time.time()
    for step in range(start, args.steps):
        state, metrics = step_fn(state, torch_batch(data.batch_at(step),
                                                    device))
        if step % 10 == 0 or step + 1 == args.steps:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0):.1f}s)")
        if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
            ckpt.save(step + 1, state)
    ckpt.wait()
    print("done")


if __name__ == "__main__":
    main()
