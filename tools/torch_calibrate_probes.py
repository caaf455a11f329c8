#!/usr/bin/env python3
"""``serving.calibrate``'s probes on one CUDA card, each the way the JAX
package sizes or times it and the way the port does.

    python3 tools/torch_calibrate_probes.py

- the matmul probe: the JAX package's 384 x 384 fp32 product, and the
  port's, grown until it is not launch-bound (``_matmul_probe``);
- the copy probe: the JAX package's 16 MiB, and the port's, sized beyond
  the card's L2 (``_copy_elems``);
- the dispatch probe: between CUDA events (device time), and on the
  host's clock around the launch and its wait (the port's dispatch leg);
- ``calibrate()`` itself, and the H100's data sheet (fp32 67 TFLOP/s,
  3.35 TB/s) beside it.

Prints the card's name and power limit, then one JSON line. Each time
is the best of 3 warm calls (``serving.model._best``).
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.serving import model as sm

    card = cs._environment(torch)
    dev = torch.device("cuda", torch.cuda.current_device())
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    out = {"phase": "calibrate_probes", "card": card, "l2_bytes": l2,
           "data_sheet": {"flops_per_sec": cs._PEAK_FLOPS["float32"],
                          "bytes_per_sec": cs._PEAK_BYTES_PER_S}}
    a = torch.ones(384, 384, device=dev)
    t = sm._best(torch.matmul, (a, a), dev)
    out["matmul_384"] = {"n": 384, "seconds": t,
                         "flops_per_sec": 2.0 * 384 ** 3 / t}
    n, t = sm._matmul_probe(384, dev)
    out["matmul_sized"] = {"n": n, "seconds": t,
                           "flops_per_sec": 2.0 * n ** 3 / t}
    del a
    for name, elems in (("copy_16MiB", (16 << 20) // 4),
                        ("copy_sized", sm._copy_elems(16, l2))):
        x = torch.ones(elems, device=dev)
        t = sm._best(torch.mul, (x, 1.0000001), dev)
        out[name] = {"bytes_moved": 8 * elems, "seconds": t,
                     "bytes_per_sec": 8 * elems / t}
        del x
    s = torch.ones((), device=dev)
    out["dispatch_s"] = {
        "device_events": sm._best(torch.add, (s, 1.0), dev),
        "host_wall": sm._best(torch.add, (s, 1.0), dev, host=True)}
    out["calibrate"] = sm.calibrate(device=dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
