"""The LM serving launcher (``repro_torch.launch.serve --mode lm``) and the
LM examples on the CPU.

Each family's smoke config serves 2 waves through the launcher and prints
the reference's two line forms (``wave i: generated G tokens x B
requests``, ``served R requests, N tokens in S s (X tok/s)``); ``--mode
vq`` still runs; the same seed serves the same tokens; the launcher serves
the weights its seed draws; the examples ``serve_lm_torch.py`` and
``embedding_vq_torch.py`` exit 0 at their smoke sizes; and without a card
every entry point raises.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.launch import serve as serve_cli
from repro_torch.models import quantization
from repro_torch.models.api import get_api

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WAVE = re.compile(r"^wave (\d+): generated (\d+) tokens x (\d+) requests$",
                  re.M)
SERVED = re.compile(r"^served (\d+) requests, (\d+) tokens in [\d.]+s "
                    r"\([\d,]+ tok/s\)$", re.M)
SMALL = ["--waves", "2", "--batch", "2", "--prompt", "8", "--gen", "4"]


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_serve_lm_smoke_runs_every_family(arch, capsys):
    rc = serve_cli.main(["--mode", "lm", "--arch", arch, "--smoke",
                         "--device", "cpu", *SMALL])
    out = capsys.readouterr().out
    assert rc == 0
    assert WAVE.findall(out) == [("0", "4", "2"), ("1", "4", "2")]
    assert SERVED.findall(out) == [("4", "16")]


def _args(*extra):
    return serve_cli.parse_args(["--arch", "hymba_1p5b", "--smoke",
                                 "--device", "cpu", *SMALL, *extra])


def test_lm_is_the_default_mode_and_the_same_seed_serves_the_same_tokens():
    args = _args()
    assert args.mode == "lm" and args.seed == 0
    a, b = serve_cli.run_lm(args), serve_cli.run_lm(_args())
    assert a.rc == b.rc == 0 and len(a.tokens) == 2
    assert a.tokens[0].shape == (2, 4)
    assert all(torch.equal(x, y) for x, y in zip(a.tokens, b.tokens))
    assert len(a.prefill_ms) == len(a.decode_ms) == 2 and a.tok_s > 0
    c = serve_cli.run_lm(_args("--seed", "1"))
    assert not all(torch.equal(x, y) for x, y in zip(a.tokens, c.tokens))


def test_run_lm_serves_the_weights_its_seed_draws():
    """The launcher's greedy tokens are the model's: ``--seed`` draws the
    weights ``init`` draws from it, and the tokens are those a decode loop
    over them gives."""
    cfg = registry.get_smoke_config("granite_8b")
    api = get_api(cfg)
    params = api.init(3, device="cpu")
    args = serve_cli.parse_args(["--arch", "granite_8b", "--smoke",
                                 "--device", "cpu", "--waves", "1",
                                 "--batch", "2", "--prompt", "5", "--gen",
                                 "3", "--seed", "3"])
    run = serve_cli.run_lm(args)
    assert all(torch.equal(x, y) for x, y in zip(
        quantization._leaves(run.params), quantization._leaves(params)))
    gen = torch.Generator().manual_seed(3)
    prompts = torch.randint(0, cfg.vocab, (2, 5), generator=gen)
    logits, cache = api.prefill(params, {"tokens": prompts}, 8)
    want = []
    tok = torch.argmax(logits, dim=-1)[:, None]
    for _ in range(3):
        want.append(tok)
        logits, cache = api.decode_step(params, cache, tok)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    assert torch.equal(run.tokens[0], torch.cat(want, dim=1))


def test_vlm_cache_holds_the_patch_positions():
    """InternVL2's requests carry img_tokens patch positions: the cache is
    sized for them, so no decode step writes past it."""
    run = serve_cli.run_lm(serve_cli.parse_args(
        ["--arch", "internvl2_76b", "--smoke", "--device", "cpu",
         "--waves", "1", "--batch", "2", "--prompt", "16", "--gen", "16"]))
    assert run.rc == 0 and run.tokens[0].shape == (2, 16)


def test_vq_mode_still_serves(capsys):
    rc = serve_cli.main(["--mode", "vq", "--smoke", "--requests", "20",
                         "--dim", "8", "--kappa", "8", "--tick-ms", "0",
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "0 failed" in out and "plan=direct" in out
    assert not WAVE.search(out)


def _example(stem):
    path = REPO / "examples" / f"{stem}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{stem}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_lm_example_runs_on_the_cpu(capsys):
    mod = _example("serve_lm")
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    gen = re.search(r"generated \((\d+), (\d+)\): \[([\d, ]+)\]", out)
    assert gen and (int(gen[1]), int(gen[2])) == (mod.BATCH, mod.GEN)
    assert "tok/s" in out


def test_embedding_vq_example_runs_on_the_cpu(capsys):
    mod = _example("embedding_vq")
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    m = re.search(r"distortion: ([\d.]+) -> ([\d.]+)", out)
    assert m and float(m[2]) < float(m[1])
    assert "of 512 rows" in out


def test_embedding_vq_cluster_assigns_every_row_to_its_nearest_code():
    mod = _example("embedding_vq")
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((400, 16)).astype(
        np.float32))
    out = mod.cluster(table)
    d2 = torch.cdist(table.double(), out["w"].double()) ** 2
    assert torch.equal(out["assign"].long(), torch.argmin(d2, dim=1))
    assert out["after"] < out["before"]
    np.testing.assert_allclose(out["after"], float(out["mind"].mean()),
                               rtol=1e-6)


def test_lm_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.get_smoke_config("granite_8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_api(cfg).init(0)
    for stem in ("serve_lm", "embedding_vq"):
        with pytest.raises(RuntimeError, match="CUDA"):
            _example(stem).main([])
