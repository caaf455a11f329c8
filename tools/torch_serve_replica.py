#!/usr/bin/env python3
"""One serving replica process of paddle_tpu_torch: an engine behind the
status server's /generate, /drain, /healthz, /status and /metrics.

    python3 tools/torch_serve_replica.py [--device cuda|cpu] [--port P]
        [--vocab V --n-layer L --n-head H --d-model D --max-seq-len T]
        [--max-batch B --kv-blocks N --block-size S
         --prefill-buckets 32,128,512] [--slo-s SECONDS] [--seed K]

Boot, in order: the parameters come from the ``.npz`` that
``PADDLE_TPU_SERVE_PARAMS`` names (every replica of a set loads the same
one, which is what makes a request re-dispatched to another replica
produce the same tokens), or else from ``init_params(seed)``; the
engine's programs are warmed on its own pages (``warm(full=True)``: on
the card every decode, prefill and score program is captured, so
requests only replay); the decode roofline
(``DecodeModel.decode_roofline(1.0, calibrate())``) is installed on the
serving ledger, which also seeds admission shedding's cold-start
estimate; the engine is registered with ``serving.set_replica_engine``
and started. The status server listens on ``--port``, else on
``PADDLE_TPU_STATUS_PORT``, else on a free loopback port. Then one line
``READY {...}`` on stdout carries the port, the pid, the boot seconds and
the decode program's cost record, and the process serves until SIGTERM
(the engine stops, the journal flushes) or SIGKILL.

``serving.router.HttpReplica("name", "http://127.0.0.1:<port>")`` is its
client; ``chip_smoke.py``'s ``serve_tier`` phase runs two of these on one
card behind a ``Router``. ``--device`` defaults to ``cuda``; pass
``--device cpu`` to serve on the CPU.
"""
import argparse
import json
import os
import signal
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--port", type=int, default=None,
                    help="status server port (default: "
                    "PADDLE_TPU_STATUS_PORT, else a free one)")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--n-layer", type=int, default=12)
    ap.add_argument("--n-head", type=int, default=12)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--max-seq-len", type=int, default=1024)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--kv-blocks", type=int, default=320)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prefill-buckets", default="32,128,512")
    ap.add_argument("--slo-s", type=float, default=30.0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np

    from paddle_tpu_torch import flags as _flags
    from paddle_tpu_torch import serving, status
    from paddle_tpu_torch.serving import ledger

    t0 = time.perf_counter()
    cfg = serving.GPTConfig(vocab_size=args.vocab, n_layer=args.n_layer,
                            n_head=args.n_head, d_model=args.d_model,
                            max_seq_len=args.max_seq_len)
    params_path = str(_flags.env_flag("PADDLE_TPU_SERVE_PARAMS"))
    if params_path and os.path.exists(params_path):
        with np.load(params_path) as z:
            params = {k: np.asarray(z[k]) for k in z.files}
        source = "npz"
    else:
        params = serving.init_params(cfg, seed=args.seed)
        source = "init"
    model = serving.DecodeModel(
        cfg, params=params, max_batch=args.max_batch,
        n_blocks=args.kv_blocks, block_size=args.block_size,
        prefill_buckets=[int(x) for x in args.prefill_buckets.split(",")],
        device=args.device)
    engine = serving.ServingEngine(model, default_slo_s=args.slo_s)
    engine.warm(full=True)
    calib = serving.calibrate(device=model.device)
    ledger.set_roofline(model.decode_roofline(1.0, calibration=calib))
    serving.set_replica_engine(engine)
    engine.start()
    if args.port is not None and status.server_port() not in (None,
                                                              args.port):
        status.stop_status_server()  # --port over PADDLE_TPU_STATUS_PORT
    if status.server_port() is None:
        status.start_status_server(port=args.port or 0)

    def _term(signum, frame):
        try:
            engine.stop(flush=True)
        finally:
            os._exit(0)

    signal.signal(signal.SIGTERM, _term)
    cost = model.insights["decode"]
    print("READY " + json.dumps({
        "rank": args.rank,
        "port": status.server_port(),
        "pid": os.getpid(),
        "device": str(model.device),
        "params_source": source,
        "boot_seconds": round(time.perf_counter() - t0, 3),
        "calibration": calib,
        "decode_cost": {"key_hash": cost.key_hash, "flops": cost.flops,
                        "bytes_accessed": cost.bytes_accessed,
                        "bytes_as_written": cost.bytes_as_written,
                        "terms": cost.terms},
    }), flush=True)
    while True:  # the engine thread serves; a signal ends the process
        time.sleep(0.5)


if __name__ == "__main__":
    sys.exit(main())
