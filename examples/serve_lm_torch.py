"""Batched LM serving on the PyTorch port: prefill a batch of prompts, then
decode greedily through the serve step, the KV cache filled by the
prefill.

The port's counterpart of ``examples/serve_lm.py``, at granite-8b's smoke
config (2 layers, d_model 128, f32) with random weights from the seed.

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]

``python -m repro_torch.launch.serve --arch granite_8b`` serves the
published config (36 layers, d_model 4,096, bf16) in waves.
"""

import argparse
import time

import torch

from repro_torch import device as device_lib
from repro_torch.configs import registry
from repro_torch.models.api import get_api
from repro_torch.training import steps as steps_lib

BATCH, PROMPT, GEN = 4, 12, 24
SEED = 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device_lib.pin_full_f32()
    dev = device_lib.resolve(args.device)
    cfg = registry.get_smoke_config("granite_8b")
    params = get_api(cfg).init(SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                            device=dev)
    max_len = PROMPT + GEN
    serve = steps_lib.make_serve_step(cfg)
    prefill = steps_lib.make_prefill_step(cfg, max_len=max_len)

    # one forward over the whole prompt fills the KV cache (its exactness
    # against teacher-forced decode: tests/test_torch_model_properties.py)
    logits, cache = prefill(params, {"tokens": prompts})

    out = []
    tok = torch.argmax(logits, dim=-1)[:, None]
    device_lib.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(GEN):
        out.append(tok)
        logits, cache = serve(params, cache, tok)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    device_lib.synchronize(dev)
    dt = time.perf_counter() - t0
    generated = torch.cat(out, dim=1)
    print(f"prompts   {tuple(prompts.shape)}: {prompts[0].tolist()}")
    print(f"generated {tuple(generated.shape)}: {generated[0].tolist()}")
    print(f"decode throughput: {BATCH * GEN / dt:,.0f} tok/s "
          f"({cfg.name} on {dev})")


if __name__ == "__main__":
    main()
