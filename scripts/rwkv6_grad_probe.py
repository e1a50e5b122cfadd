#!/usr/bin/env python3
"""How sensitive is rwkv6-7b's training gradient to the rounding of the WKV
scan's output?  One loss and gradient of ``launch/train.py``'s first batch
(8 of 32 layers, seq 256, ``f32`` precision, weights from seed 0) on one
card, the WKV forward taken each time from another route:

* the CUDA kernel (the port's path);
* its plain version (``kernels/ref.py``) and the same recurrence in float64,
  both on the card and both rounded to the activations' bf16;
* the kernel with position 0 of every row taken from the plain version;
* the plain version with its position-0 output scaled by 1 -/+ 0.3%.

The backward is the op's own plain recompute in every route, so only the
forward values differ.  It prints the loss and the global gradient norm of
each route, with the card's name and power limit.

    python3 scripts/rwkv6_grad_probe.py
"""
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R
    from repro_torch.launch.train import train_session_factory
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train.steps import value_and_grad

    if not torch.cuda.is_available():
        raise SystemExit("rwkv6_grad_probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    kernel = ops._rwkv6_scan_cuda

    def plain(r, k, v, w, u):
        return R.rwkv6_scan_ref(r, k, v, w, u)

    def float64(r, k, v, w, u):
        B, S, H, D = r.shape
        rf, kf, vf, wf = (t.double() for t in (r, k, v, w))
        uf = u.double()
        s = torch.zeros((B, H, D, D), dtype=torch.float64, device=r.device)
        outs = []
        for t in range(S):
            kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
            outs.append(torch.einsum("bhd,bhde->bhe", rf[:, t], s + uf[..., :, None] * kv))
            s = wf[:, t, :, :, None] * s + kv
        return torch.stack(outs, 1).to(r.dtype), s.float()

    def kernel_t0_plain(*a):
        out, state = kernel(*a)
        out[:, 0] = plain(*a)[0][:, 0]
        return out, state

    def plain_t0_scaled(scale):
        def route(*a):
            out, state = plain(*a)
            out[:, 0] = (out[:, 0].float() * scale).to(out.dtype)
            return out, state
        return route

    session = train_session_factory(arch="rwkv6-7b", device=dev, full_config=True, n_layers=8,
                                    seq=256, steps=1, precision="f32")
    session.compile()
    params, _ = session.init_state()
    batch = session.dataset.next_device_batch(dev)
    routes = [("kernel", kernel), ("plain", plain), ("float64", float64),
              ("kernel, position 0 from plain", kernel_t0_plain),
              ("plain, position 0 x 0.997", plain_t0_scaled(0.997)),
              ("plain, position 0 x 1.003", plain_t0_scaled(1.003))]
    for label, route in routes:
        ops._rwkv6_scan_cuda = route
        try:
            (_, parts), grads = value_and_grad(session.model, params, batch)
        finally:
            ops._rwkv6_scan_cuda = kernel
        norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
        print(f"{label}: loss {float(parts['loss']):.6f}, grad norm {float(norm):.4f}", flush=True)
        del grads
    return 0


if __name__ == "__main__":
    sys.exit(main())
