"""lighthouse-tpu's PyTorch/CUDA port: the command line.

    python -m lighthouse_tpu_torch autotune calibrate [--smoke] [--out PATH] ...
    python -m lighthouse_tpu_torch autotune show [--profile PATH]

`autotune calibrate` measures the BLS verification padding buckets on the
card (the "torch" backend; `--smoke`: a CPU dry-run on the "python"
backend and the small fixtures) and writes the autotune profile that
`autotune.runtime.autoload` installs; `autotune show` prints a profile and
the plan derived from it. The JAX package's CLI (`lighthouse_tpu/cli.py`)
has more subcommands; they come with the layers they drive.
"""

from __future__ import annotations

import argparse
import json
import sys


def cmd_autotune(args):
    """`autotune calibrate` — measure this card's padding buckets and
    write its profile; `autotune show` — print a profile + derived plan
    (lighthouse_tpu_torch/autotune)."""
    import dataclasses

    from .autotune import calibrate as _cal
    from .autotune import planner as _planner
    from .autotune import profile as _prof

    if args.autotune_command == "calibrate":
        _profile, path = _cal.run_from_args(args)
        print(json.dumps({"profile": path}))
        return 0
    if args.autotune_command == "show":
        path = args.profile
        if path is None:
            # bounded detection: a first CUDA call must not hang this
            # command (the same guard as the runtime's autoload)
            from .autotune import runtime as _at_runtime

            key = _at_runtime.detect_device_key(wait_secs=10.0)
            if key is None:
                print("device detection failed or timed out; pass "
                      "--profile PATH explicitly", file=sys.stderr)
                return 1
            path = _prof.default_path(key)
        try:
            p = _prof.load(path)
        except FileNotFoundError:
            print(f"no autotune profile at {path} "
                  f"(run `autotune calibrate` on the device)",
                  file=sys.stderr)
            return 1
        except (ValueError, json.JSONDecodeError) as e:
            print(f"unreadable autotune profile at {path}: {e}",
                  file=sys.stderr)
            return 1
        plan = _planner.plan_from_profile(p)
        print(json.dumps(
            {"path": path, "plan": dataclasses.asdict(plan),
             "profile": p.to_json()},
            indent=1,
        ))
        return 0
    print("unknown autotune command", file=sys.stderr)
    return 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lighthouse-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    at = sub.add_parser(
        "autotune",
        help="device autotuner: calibrate or inspect the BLS pipeline "
             "profile (lighthouse_tpu_torch/autotune)",
    )
    atsub = at.add_subparsers(dest="autotune_command", required=True)
    atc = atsub.add_parser(
        "calibrate",
        help="measure the padding buckets on this card and write its "
             "profile (use --smoke for a CPU dry-run)",
    )
    from .autotune.calibrate import add_calibrate_args

    add_calibrate_args(atc)
    ats = atsub.add_parser(
        "show", help="print a device profile and the plan derived from it"
    )
    ats.add_argument("--profile", default=None,
                     help="profile path (default: this card's canonical "
                          "path under build/autotune)")
    for p_ in (atc, ats):
        p_.set_defaults(fn=cmd_autotune)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    raise SystemExit(main())
