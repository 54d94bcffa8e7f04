#!/usr/bin/env python3
"""The JAX package's test F1s in chip_smoke.py's quality configuration
(``QUALITY_KW``, tests/test_quality.py's: SyntheticSBMLow, f32, nhid 64,
60 epochs, one run), on the CPU: the reference that chip_smoke.py prints
beside the port's F1s on the card (``QUALITY_JAX_REFERENCE``).

    JAX_PLATFORMS=cpu python3 tools/quality_reference.py [SEED ...]

One JSON line per seed (default 42, the configuration's): the platform,
the commit of the checkout, the seed and the final test F1 of learned,
random and full.
"""
import json
import subprocess
import sys

sys.path.insert(0, ".")
import jax

jax.config.update("jax_platforms", "cpu")

import chip_smoke as cs                                     # noqa: E402
from sgs_gnn_tpu.core import Config                         # noqa: E402
from sgs_gnn_tpu.data.registry import get_dataset           # noqa: E402
from sgs_gnn_tpu.run.driver import run_experiment           # noqa: E402


def main(seeds):
    commit = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                            capture_output=True, text=True).stdout.strip()
    for seed in seeds:
        cfg = Config(**cs.QUALITY_KW, donate=False, seed=seed)
        ds = get_dataset(cfg)
        f1 = {}
        for mode in cs.QUALITY_MODES:
            (res,) = run_experiment(cfg.replace(mode=mode), ds,
                                    log_fn=lambda *a: None)
            f1[mode] = res.final_test_f1
        print(json.dumps(dict(platform=jax.default_backend(), commit=commit,
                              seed=seed, config=cs.QUALITY_KW,
                              test_f1=f1)), flush=True)


if __name__ == "__main__":
    main([int(s) for s in sys.argv[1:]] or [42])
