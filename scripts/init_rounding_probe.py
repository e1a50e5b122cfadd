#!/usr/bin/env python3
"""How far apart are the CPU's and the card's float32 training logits of the
whisper-medium, qwen2-vl-7b and deepseek-7b smoke configs, and is it the
attention kernel?

One ``Model.forward`` of a batch drawn from a seed (4 rows of 16 tokens,
stub frames / 4 stub patches) on the CPU (plain versions) and on the card,
twice on the card: through the flash kernel, and with the plain attention
(``kernels/ref.py``) in its place.  Each from the port's seed-0 weights
(whose q/k/v std reads the stacked leaf's fan-in from its layer axis, as
the reference's init does) and from ``chip_smoke.fan_in_weights`` of them.
It prints the largest |logit| and the largest |CPU - card| of each route
(for whisper also of the encoder's output), with the card's name and power
limit.

    python3 scripts/init_rounding_probe.py
"""
import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch

    import chip_smoke as CS
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R
    from repro_torch.models import encdec as E
    from repro_torch.models.api import get_model

    if not torch.cuda.is_available():
        print("init_rounding_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(CS.card_line())
    kernel_fwd = ops._FlashAttention.forward

    def plain_fwd(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return R.flash_attention_ref(q, k, v, causal=causal, window=window)

    for arch in ("whisper-medium", "qwen2-vl-7b", "deepseek-7b"):
        cfg = smoke_config(arch)
        model = get_model(cfg)
        port, _ = model.init_params(seed=0, device="cpu")
        gen = torch.Generator()
        gen.manual_seed(28)
        b = CS._side_batch(torch, cfg, 4, 16, 4, gen, "cpu")
        side = {k: b[k] for k in ("frames", "patch_embeds") if k in b}
        gside = {k: v.to(dev) for k, v in side.items()}
        for init, params in (("port init", port),
                             ("fan-in", CS.fan_in_weights(torch, port, 3))):
            gparams = CS._to(copy.deepcopy(params), dev)
            diff = {}
            with torch.no_grad():
                want, _ = model.forward(params, b["tokens"], **side)
                for route, fwd in (("kernels", kernel_fwd), ("plain attention", plain_fwd)):
                    ops._FlashAttention.forward = staticmethod(fwd)
                    got, _ = model.forward(gparams, b["tokens"].to(dev), **gside)
                    diff[route] = (want - got.cpu()).abs().max().item()
                    if cfg.family == "encdec":
                        enc = E.encode(params, cfg, side["frames"])
                        diff[route + ", encoder output"] = (
                            enc - E.encode(gparams, cfg, gside["frames"]).cpu()).abs().max().item()
                ops._FlashAttention.forward = staticmethod(kernel_fwd)
            print(f"{arch} {init}: max |logit| {want.abs().max().item():.3f}; max |CPU - card| "
                  + ", ".join(f"{k} {v:.3e}" for k, v in diff.items()))
    print(CS.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
