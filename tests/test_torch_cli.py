"""The port's `bn` entry point (cli.py `cmd_bn`, `python -m
lighthouse_tpu_torch bn`) on the CPU.

- the weak-subjectivity guards: a malformed `--wss-checkpoint` and one on a
  genesis start refuse to start (exit 1, the reference's messages);
- `--purge-db` wipes planted database files before the store opens, and
  `--shutdown-after-sync` exits 0 at the first slot tick;
- restart resume: a node started over a datadir persists its chain on
  SIGTERM, and a node started from the datadir alone (no genesis flags)
  resumes it ("restart resume complete") and persists again;
- `--bls-backend torch`, the default, exits non-zero without a card with
  the backend's error, before any verification;
- the `bn` parser's option strings, defaults, choices and types equal the
  JAX package's, but for the listed differences: `--bls-backend` (choices
  "torch" for "jax", default "torch"), `--hash-backend` (default
  "device"), no `--no-donate`, and no sub-subcommands.
- the BLS warm-up `cmd_bn` starts under a Supervisor: one failure is
  restarted, then every bucket warms, as in the JAX package.

The nodes run "fake" BLS, the "host" hash backend, no p2p and ephemeral
ports (minimal spec, 4 or 16 interop validators), as subprocesses.
"""

import os
import signal
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODE = ["bn", "--spec", "minimal", "--bls-backend", "fake", "--hash-backend", "host",
        "--disable-p2p", "--zero-ports"]
MARKER = b"\x00garbage that is not a valid kv store"


def start(args, **kw):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-m", "lighthouse_tpu_torch", *args], cwd=REPO,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            **kw)


def finish(proc, timeout=120):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, out, err


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    """The file's node runs, started together (each waits seconds for a
    slot tick or its imports): name -> (Popen, its directory)."""
    import torch

    tmp = tmp_path_factory.mktemp("bn")
    (tmp / "purge").mkdir()
    (tmp / "purge" / "hot.db").write_bytes(MARKER)
    runs = {
        "wss_malformed": NODE + ["--interop-validators", "4", "--wss-checkpoint",
                                 "not-a-checkpoint"],
        "wss_genesis": NODE + ["--interop-validators", "4", "--wss-checkpoint",
                               "0x" + "11" * 32 + ":3"],
        "purge": NODE + ["--interop-validators", "4", "--datadir", str(tmp / "purge"),
                         "--purge-db", "--shutdown-after-sync"],
        "resume_first": NODE + ["--interop-validators", "16", "--datadir", str(tmp / "resume"),
                                "--shutdown-after-sync"],
    }
    if not torch.cuda.is_available():
        runs["torch_no_card"] = ["bn", "--spec", "minimal", "--interop-validators", "4",
                                 "--disable-p2p", "--zero-ports"]
    procs = {name: start(args) for name, args in runs.items()}
    yield procs, tmp
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_bn_wss_checkpoint_guards(nodes):
    procs, _tmp = nodes
    rc, _out, err = finish(procs["wss_malformed"])
    assert rc == 1
    assert "0xROOT:EPOCH" in err
    rc, _out, err = finish(procs["wss_genesis"])
    assert rc == 1
    assert "requires a checkpoint start" in err


def test_bn_purge_db_and_shutdown_after_sync(nodes):
    procs, tmp = nodes
    rc, out, err = finish(procs["purge"])
    assert "database purged" in out + err
    assert "shutdown: synced" in out + err
    assert rc == 0, err[-2000:]
    assert (tmp / "purge" / "hot.db").read_bytes() != MARKER


def test_bn_restart_resume_from_the_datadir_alone(nodes):
    procs, tmp = nodes
    rc, _out, err = finish(procs["resume_first"])
    assert rc == 0, err[-2000:]
    assert "chain persisted; store flushed and closed" in err
    head = err.split("chain persisted; store flushed and closed")[1].split("head: ")[1][:8]

    # from the datadir alone; SIGTERM once the slot timer runs (cmd_bn's
    # handler is in place by then)
    proc = start(NODE + ["--datadir", str(tmp / "resume")], bufsize=1)
    lines = []
    try:
        for line in proc.stderr:
            lines.append(line)
            if "beacon_node        slot " in line:
                proc.send_signal(signal.SIGTERM)
                break
    finally:
        rc, _out, rest = finish(proc, timeout=60)
    log = "".join(lines) + rest
    assert rc == 0, log[-2000:]
    resumed = [ln for ln in lines if "restart resume complete" in ln]
    assert resumed and f"head: {head}" in resumed[0]
    assert "shutdown: SIGTERM" in log
    assert "chain persisted; store flushed and closed" in log


def test_bn_torch_backend_without_a_card_exits_nonzero(nodes):
    procs, _tmp = nodes
    if "torch_no_card" not in procs:
        pytest.skip("a CUDA card is present: the torch backend starts")
    rc, _out, err = finish(procs["torch_no_card"])
    assert rc != 0
    assert "--bls-backend torch" in err and "no CUDA device" in err
    assert "HTTP API started" not in err


def bn_options(build_parser) -> dict:
    """The bn subparser's options: option strings -> (default, choices,
    type, action class); and whether it has sub-subcommands."""
    p = build_parser()
    (sub,) = [a for a in p._subparsers._group_actions]
    bn = sub.choices["bn"]
    opts, subcommands = {}, False
    for a in bn._actions:
        if not a.option_strings:
            subcommands = subcommands or a.dest == "bn_command"
            continue
        opts[tuple(a.option_strings)] = (a.default, a.choices and list(a.choices),
                                         getattr(a.type, "__name__", a.type), type(a).__name__)
    return opts, subcommands


def test_bn_parser_matches_the_reference_but_for_the_listed_differences():
    from lighthouse_tpu import cli as jcli

    from lighthouse_tpu_torch import cli

    want, want_sub = bn_options(jcli.build_parser)
    got, got_sub = bn_options(cli.build_parser)
    assert want_sub and not got_sub
    assert got.pop(("--bls-backend",)) == ("torch", ["python", "torch", "fake", "hybrid"],
                                           None, "_StoreAction")
    assert want.pop(("--bls-backend",)) == ("python", ["python", "jax", "fake", "hybrid"],
                                            None, "_StoreAction")
    assert got.pop(("--hash-backend",))[0] == "device"
    assert want.pop(("--hash-backend",))[0] is None
    assert want.pop(("--no-donate",))[0] is False
    assert got == want
    args = cli.build_parser().parse_args(["bn"])
    assert args.fn is cli.cmd_bn and args.bls_backend == "torch" and args.hash_backend == "device"


def test_start_warmup_under_a_supervisor_matches_the_reference():
    """`cmd_bn` hands the BLS warm-up a Supervisor: a warm-up that fails
    once is restarted and then walks every bucket, in both packages."""
    import importlib
    import random

    def run_warmup(package):
        runtime = importlib.import_module(f"{package}.autotune.runtime")
        sup = importlib.import_module(f"{package}.utils.supervisor")
        calls = []

        def warm(n_sets, n_pks):
            calls.append((n_sets, n_pks))
            if len(calls) == 2:
                raise RuntimeError("device hiccup")

        s = sup.Supervisor(name="autotune", max_restarts=2, backoff_base=0.01,
                           rng=random.Random(1))
        runtime.start_warmup(buckets=[(4, 1), (64, 128)], warm_fn=warm,
                             supervisor=s).join(10)
        return calls, dict(s.restarts), s.abandoned

    got, want = (run_warmup(p) for p in ("lighthouse_tpu_torch", "lighthouse_tpu"))
    assert got == want == ([(4, 1), (64, 128), (4, 1), (64, 128)], {"autotune_warmup": 1}, [])
