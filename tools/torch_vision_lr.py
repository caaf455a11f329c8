#!/usr/bin/env python3
"""``chip_smoke.py``'s ``vision_fit`` recipe at two learning rates, with
and without bf16 autocast, on one CUDA card.

    python3 tools/torch_vision_lr.py

ResNet-50 (1000 classes) built from ``chip_smoke._VISION_SEED``, trained
by ``Model.fit`` for ``_VISION_STEPS`` steps on the phase's one synthetic
batch of 64 x 3 x 224 x 224 with Momentum(lr, 0.9, L2 decay 1e-4): at the
recipe's own rate 0.1 and at ``_VISION_LR`` (0.025), each under
``amp.auto_cast(dtype="bfloat16")`` and in fp32 (TF32 off in cuDNN and
cuBLAS; the bf16 runs keep torch's defaults, as ``vision_fit`` does).
Every run starts from the same weights. Prints the card's name and power
limit, then one JSON line a run (its losses) and writes them to
``chiprun_out/vision_lr.jsonl``. Shows whether a climb of the loss at 0.1
comes with bf16 autocast or without it; the CPU witness that the JAX
package's loss climbs at that rate is ``tests/test_torch_vision.py``.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(torch, cs, lr, bf16):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import dygraph, vision

    # the bf16 runs keep torch's defaults, as vision_fit does
    torch.backends.cudnn.allow_tf32 = bf16
    torch.backends.cuda.matmul.allow_tf32 = False
    with dygraph.guard():
        pt.seed(cs._VISION_SEED)
        net = vision.models.resnet50(num_classes=cs._VISION_CLASSES)
        images, labels = cs._vision_batch(cs._VISION_SEED)
        data = [(images[i % cs._VISION_B], labels[i % cs._VISION_B])
                for i in range(cs._VISION_STEPS * cs._VISION_B)]
        loader = pt.io.DataLoader(data, batch_size=cs._VISION_B,
                                  shuffle=False)
        model = pt.Model(net)
        opt = pt.optimizer.Momentum(
            learning_rate=lr, momentum=0.9, parameters=net.parameters(),
            weight_decay=pt.regularizer.L2Decay(1e-4))
        model.prepare(opt, pt.nn.CrossEntropyLoss())
        log = cs._step_log(pt)
        if bf16:
            with pt.amp.auto_cast(dtype="bfloat16"):
                model.fit(loader, epochs=1, verbose=0, callbacks=[log])
        else:
            model.fit(loader, epochs=1, verbose=0, callbacks=[log])
        return [float(v) for v in log.losses]


def main() -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch

    card = cs._environment(torch)
    rows = []
    for lr in (0.1, cs._VISION_LR):
        for bf16 in (True, False):
            row = {"lr": lr, "autocast": "bfloat16" if bf16 else "off",
                   "losses": _run(torch, cs, lr, bf16), "card": card}
            print(json.dumps(row), flush=True)
            rows.append(row)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "vision_lr.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
