"""Train a ~100M-parameter dense LM on the PyTorch port for a few hundred
steps on the step-indexed synthetic pipeline, with async checkpoints and a
simulated failure at the midpoint and a restart from the latest checkpoint
(the fault-tolerance path).

The port's counterpart of ``examples/train_lm.py``, at its model (12
layers x 512, 8 heads, d_ff 2,048, a 32,768 vocabulary, f32) with random
weights from the seed.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] \\
        [--device cpu]
"""

import argparse
import math
import shutil
import tempfile

import torch

from repro_torch import device as device_lib
from repro_torch.checkpoint import Checkpointer
from repro_torch.data.pipeline import DataConfig, lm_batch
from repro_torch.models.common import ModelConfig
from repro_torch.optim import optimizers
from repro_torch.training import steps as steps_lib

LOG_EVERY, CKPT_EVERY = 20, 50


def make_100m() -> ModelConfig:
    # ~100M params: 12L x 512 x 8H, d_ff 2048, 32k vocab
    return ModelConfig(
        name="repro-100m", family="dense", n_layers=12, d_model=512,
        n_heads=8, n_kv_heads=4, d_ff=2048, vocab=32768,
        dtype=torch.float32)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device_lib.pin_full_f32()
    dev = device_lib.resolve(args.device)

    cfg = make_100m()
    print(f"model: {cfg.name} ({cfg.n_params() / 1e6:.0f}M params) on {dev}")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                      global_batch=args.batch)
    opt = optimizers.adamw(
        optimizers.cosine_schedule(3e-4, warmup=30, total=args.steps))
    step = steps_lib.make_train_step(cfg, opt, donate=True)
    state = steps_lib.init_train_state(cfg, opt, 0, device=dev)

    ckpt_dir = tempfile.mkdtemp(prefix="repro_ckpt_")
    try:
        ckpt = Checkpointer(ckpt_dir)
        half = args.steps // 2

        # ---- phase 1: train to the midpoint, checkpointing async ---------
        for i in range(half):
            state, metrics = step(state, lm_batch(dcfg, i, device=dev))
            if (i + 1) % LOG_EVERY == 0:
                print(f"step {i + 1:4d}  loss {float(metrics['loss']):.4f}")
            if (i + 1) % CKPT_EVERY == 0:
                ckpt.save_async(i + 1, state)
        ckpt.save(half, state)
        ckpt.wait()

        # ---- simulated node failure: throw the live state away -----------
        print(f"\n--- simulated failure at step {half}; restarting from "
              f"{ckpt.latest_step()} ---\n")
        del state
        state = steps_lib.init_train_state(cfg, opt, 1, device=dev)
        state = ckpt.restore(ckpt.latest_step(), state, device=dev)

        # ---- phase 2: resume; the step-indexed pipeline replays exactly --
        final = float("nan")
        for i in range(half, args.steps):
            state, metrics = step(state, lm_batch(dcfg, i, device=dev))
            if (i + 1) % LOG_EVERY == 0 or i + 1 == args.steps:
                final = float(metrics["loss"])
                print(f"step {i + 1:4d}  loss {final:.4f}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"\nfinal loss {final:.4f} (started ~{math.log(cfg.vocab):.2f})")
    return final


if __name__ == "__main__":
    main()
