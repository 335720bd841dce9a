"""A/B of `chip_smoke.serve_tp_phase` between checkouts, on one card.

Runs the tp phase of `chip_smoke.py` (llama3-8b at `SERVE_LLM_LAYERS`
layers: (a) two ranks against one process, (b) a tp=1 replica, (c) a
tp=2 replica of two `num_gpus=0.5` ranks) once per checkout given, in
the order given, each in a fresh process whose working directory is the
checkout, so that checkout's `chip_smoke` and `ray_tpu_torch` run. Give
the parent and the change in the order parent, change, change, parent
so that both sides see the same host.

    python tools/serve_tp_ab.py .bench_base/parent . . .bench_base/parent

Prints one JSON line per run (TPOT and TTFT p50 of (b) and (c), (c)'s
cards where the checkout reports them) and the card's name and power
limit; exits non-zero if a run fails.
"""
import json
import os
import subprocess
import sys

RUN = r"""
import dataclasses, json, torch
import chip_smoke as c
smi, _ = c.card()
c.build()
dev = torch.device("cuda", 0)
cfg = dataclasses.replace(c.llama3_8b(), n_layers=c.SERVE_LLM_LAYERS)
served = c.serve_tokens(dev, cfg)
out = c.serve_tp_phase(served, dev, smi, {"tpot_ms_p50": None,
                                          "layers": cfg.n_layers}, cfg=cfg)
print("AB " + json.dumps({
    "smi": smi,
    "b_tpot_ms_p50": out["b"]["tpot_ms_p50"],
    "b_ttft_ms_p50": out["b"]["ttft_ms_p50"],
    "c_tpot_ms_p50": out["c"]["tpot_ms_p50"],
    "c_ttft_ms_p50": out["c"]["ttft_ms_p50"],
    "c_tp_cards": out["c"].get("tp_cards"),
    "phase_s": out["phase_s"]}))
"""


def main(trees) -> int:
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", RUN],
                              cwd=os.path.abspath(tree),
                              capture_output=True, text=True)
        line = next((ln[3:] for ln in proc.stdout.splitlines()
                     if ln.startswith("AB ")), None)
        if proc.returncode != 0 or line is None:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            print(json.dumps({"tree": tree, "rc": proc.returncode}))
            return 1
        print(json.dumps({"tree": tree, **json.loads(line)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
