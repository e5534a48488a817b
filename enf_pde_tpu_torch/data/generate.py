"""Trajectory pre-generation CLI (counterpart of ``enf_pde_tpu/data/generate.py``).

    python -m enf_pde_tpu_torch.data.generate navier_stokes --path data/ --group train --count 256
    python -m enf_pde_tpu_torch.data.generate navier_stokes --group test --ids 0,1,2 --device cpu
    python -m enf_pde_tpu_torch.data.generate cahn_hilliard --path data/ --group train --count 64

Writes the missing ones of the given ids, ``batch_size_gen`` per solver call, to
``<path>/<cache_name>/<group>/traj_XXXXXX.npz`` (with the ``.raw`` and ``shape.json``
companions) through ``TrajectoryCache.write``, in the JAX package's format.
The solver runs on ``--device``, the card by default.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from enf_pde_tpu_torch.config import Config
from enf_pde_tpu_torch.data.cache import TrajectoryCache
from enf_pde_tpu_torch.data.registry import DATASET_NAMES, dataset_spec


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("dataset", choices=DATASET_NAMES)
    parser.add_argument("--path", default="data/")
    parser.add_argument("--group", choices=("train", "test"), default="train")
    parser.add_argument("--count", type=int, default=None, help="generate ids [0, count)")
    parser.add_argument("--ids", default=None, help="comma-separated trajectory ids")
    parser.add_argument("--device", default="cuda", help="where the solver runs (cuda | cpu)")
    args = parser.parse_args(argv)

    if args.ids:
        ids = np.asarray([int(i) for i in args.ids.split(",")])
    elif args.count:
        ids = np.arange(args.count)
    else:
        parser.error("one of --count / --ids is required")

    dcfg = Config({"name": args.dataset, "path": args.path, "traj_len_train": 10,
                   "traj_len_out_horizon": 50})
    spec = dataset_spec(args.dataset, dcfg, device=args.device)
    gen = spec.gen_train if args.group == "train" else spec.gen_test
    cache = TrajectoryCache(os.path.join(args.path, spec.cache_name, args.group), gen,
                            batch_size_gen=spec.batch_size_gen)
    for start in range(0, len(ids), spec.batch_size_gen):
        chunk = ids[start : start + spec.batch_size_gen]
        missing = [i for i in chunk if not os.path.exists(cache.path(i))]
        if not missing:
            continue
        for i, traj in zip(missing, gen(np.asarray(missing))):
            cache.write(i, traj)
        print(f"[generate] {args.dataset}/{args.group}: wrote {len(missing)} trajectories")


if __name__ == "__main__":
    main()
