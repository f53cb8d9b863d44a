"""Make the inputs of one seed: python -m portbench.gen CONFIG TRAFFIC SEED DIR KEY

The traffic file names its generator (`"generator"`), a module of this
package with a `make(config, traffic, seed, out_dir)` that writes the inputs
into DIR and returns their manifest. The manifest is written back with KEY
(what the inputs were made from) and the list of its files.
"""

import json
import os
import sys

sys.modules.setdefault("jax", None)
sys.modules.setdefault("strling_tpu", None)


def main(argv):
    import importlib

    cfg_path, tr_path, seed, out_dir, key = argv
    with open(cfg_path) as fh:
        cfg = json.load(fh)
    with open(tr_path) as fh:
        tr = json.load(fh)
    gen = importlib.import_module(f"portbench.gen.{tr['generator']}")
    m = gen.make(cfg, tr, int(seed), out_dir)
    m["key"] = key
    m["files"] = [k for k, v in m.items() if isinstance(v, str)
                  and os.path.isfile(v)]
    with open(os.path.join(out_dir, "manifest.json"), "w") as fh:
        json.dump(m, fh, indent=1)
    print(f"[portbench] made {m.get('n_records')} records in "
          f"{m.get('gen_s', 0):.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main(sys.argv[1:])
