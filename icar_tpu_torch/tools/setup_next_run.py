"""Prepare an options file to resume (chain) a simulation from restart.

The port's counterpart of tools/setup_next_run.py (the reference's
helpers/setup_next_run.py), with its arguments and outputs: given an
options namelist, check that a restart checkpoint exists for its
configured restart_file prefix and rewrite the namelist with
``restart = .True.``, so that the next ``python -m icar_tpu_torch
options.nml`` resumes from the latest checkpoint (the driver picks the
newest ``<restart_file>*.nc``; core/driver.py). With ``-s N`` the N last
files in sorted order are deleted first, stepping the resume point back
(e.g. past a corrupted tail). Restarts per shard
(``{prefix}img{sid:03d}_{t:08d}.nc``) sort by shard before time, so there
``-s N`` removes the last shard's N files, as the JAX tool does.

Usage:
    python -m icar_tpu_torch.tools.setup_next_run options.nml \\
        [-o next_options.nml] [-s N]
"""

import argparse
import glob
import os
import re
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("options_file")
    p.add_argument("-o", "--output", default=None,
                   help="write the updated namelist here (default: in place)")
    p.add_argument("-s", "--skip", type=int, default=0,
                   help="step back N restart files (deletes them)")
    args = p.parse_args(argv)

    from icar_tpu_torch.config import Options
    o = Options.from_namelist(args.options_file)

    checkpoints = sorted(glob.glob(o.output.restart_file + "*.nc")
                         + glob.glob(o.output.restart_file + "*.npz"))
    if args.skip:
        for path in checkpoints[len(checkpoints) - args.skip:]:
            print(f"removing {path}")
            os.remove(path)
        checkpoints = checkpoints[:len(checkpoints) - args.skip]
    if not checkpoints:
        print(f"no restart checkpoints match {o.output.restart_file}*.nc|npz",
              file=sys.stderr)
        return 1
    print(f"will resume from {checkpoints[-1]}")

    text = open(args.options_file).read()
    if re.search(r"(?im)^\s*restart\s*=", text):
        text = re.sub(r"(?im)^(\s*)restart\s*=\s*\S+,?",
                      r"\1restart = .True.,", text)
    else:
        # insert into the parameters group (the reference reads restart
        # from &parameters; options_obj.f90:476)
        text = re.sub(r"(?im)^(&parameters\s*)$",
                      r"\1\n    restart = .True.,", text, count=1)
    out = args.output or args.options_file
    open(out, "w").write(text)
    print(f"wrote {out} (restart = .True.)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
