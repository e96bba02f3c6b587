#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (lighthouse_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:
  1. device and build: nvidia-smi name and power limit, torch/CUDA
     versions, the nvcc build of csrc/*.cu and ptxas's registers/spills;
  2. field self-test: the fq_mont_mul kernel against the plain mont_mul on
     2^20 seeded random elements and every pair of edge operands, and by
     R^2 (the Montgomery conversion) on 2^20 of them (torch.equal); the
     field sweep: a * b at 130, 2^14, 2^20 and 2^22 seeded elements, each
     equal to the plain version, with its CUDA-event ms, that of a torch op
     moving the same bytes, and its three floors (the interchange's 192
     bytes an element over HBM's rate, the 48 bytes an element holds, the
     products' IMADs over the integer rate; device ms and the share of the
     interchange floor reached come from the profiler at the end);
     product_latency: csrc/latency.cu's chains of dependent Fq products,
     team levels and Fq inversions (the Fermat chain against fq.cuh's
     binary GCD, one thread and a warp), each held against its plain chain;
     inverse: the binary GCD against the Fermat chain on 2^16 seeded random
     elements and the edge inputs (the count that differ);
  3. each kernel against its plain version on the card (torch.equal), on
     the real stage data of the 64 x 128 gossip batch, the 512-key sync
     aggregate and the one-key urgent verify, with its time (CUDA events),
     the plain version's time and its bound (miller_loop_batch, phase 1 of
     the Miller kernel, per pair); a schedule line per bucket with the
     counts that are not measured (the Fq products of each bound, the
     Miller and hard-part kernels' own products, dependent product rounds
     and passes, the team kernels' dependent levels), and the per-round and
     per-pass costs solved from the two round kernels; then
     hash_to_g2 on a batch of edge lanes (u = 0, the EF vectors' messages,
     seeded random u-values with is_qr true and false);
  4. the paths through the public API, set_backend("torch"), each driven
     with every launch count set to 0 just before it and read just after,
     and failed unless each kernel of its list launched in it:
     gossip (64 aggregate attestations x 128 pubkeys from bench_fixtures.npz,
     three verifies; the median gives sets/s), tampered (one message byte
     flipped: must not verify), sync (the 512-key Altair sync aggregate),
     async (8 submissions of the gossip batch through
     bls.verify_signature_sets_async at depth 4, the 5th tampered: verdicts
     in FIFO order), urgent (bls.verify of one fixture key while four
     batches fill the window), aggregate_verify (the 64 sets as one
     distinct-message AggregateVerify, its pair assembly on fq_mont_mul and
     stage_pairs; a flipped message byte must fail);
  5. the 15 EF BLS vectors through the port's API;
  6. per-stage times of the gossip batch and hash-to-G2 of one message
     against the pure-Python RFC 9380 map; then the KZG path
     (bench_fixtures.npz's 4096-point dev setup and 6 blobs, Deneb's blob
     cap at mainnet width), after every earlier path's phase:
     blob_to_kzg_commitment and compute_blob_kzg_proof of each blob equal
     to the fixture's, verify_blob_kzg_proof_batch true, false with a
     flipped blob byte and with two proofs swapped, verify_blob_kzg_proof
     true (msm_precompute must launch once on it: the comb tables are
     cached per point list), the median of five batch verifies and the
     host's parts of one; the three MSM kernels against their plain
     versions at the path's full width (the 4096 points, the 65536 comb
     lanes with blob 0's scalars, with every chunk equal and with every
     chunk 0, the batch verify's C' and W' buckets at w = 0, 2, 4, 5 and
     6), on 256 points (a quarter of them the identity, too), on the
     comb's edge scalars (0, 1, R, R - 1; msm_precompute on their six
     points, one the identity) and on [P, -P] and [P, P]; a digit outside
     its width refused;
  7. the tree-hash and epoch paths of lighthouse_tpu_torch.torchhash at
     the mainnet registry's width, 2^20 validators, driven like the BLS
     paths: state_root (the port's loadgen run_state_root_scenario on
     state_root_1m: a seeded synthetic state, its cold root, then 4 slots
     of clone_state, 8 validator and 32 balance writes and a re-root; the
     scenario's report printed; the roots distinct,
     the last equal to uncached_state_root's host rehash, the balances
     conserved, the router's device/ok routes and no host/device_error;
     the host hashlib ladder over the validators' roots as the yardstick)
     and epoch (process_epoch at slot 3 * SLOTS_PER_EPOCH - 1 through the
     epoch_deltas kernel, equal to the pure-Python run on a deep copy, no
     device failure counted); then sha256_ladder, sha256_msgs and
     epoch_deltas against their plain versions on the card (the ladder on
     the validators' roots, on 2^20 random leaves, at small widths and on
     zero leaves, whose levels are ZERO_HASHES; the digests against hashlib
     at the padding edges; the deltas on the epoch path's inputs, steady
     and in a leak, and on numerators in [2^63, 2^64));
  8. hybrid: bls.set_backend("hybrid") over the same card, the launch counts
     reset at its start: the router's probe waited for (its seconds and
     current_device_key() printed), which must end "up"; the urgent (4, 1)
     verify of small_*[0] first to host/device_cold (the warm in the
     background), then to device/ok, a tampered one false; three gossip
     (64, 128) verifies through the router alternated with three straight
     through "torch" (the medians' difference is the router's overhead),
     the tampered batch false; 8 verify_signature_sets_async at (64, 128),
     the 5th tampered, seven true and one false in order; AggregateVerify
     of the 64 messages; the KZG fixture's 6 commitments through the
     router's g1_msm_fixed, equal to the fixture's. bls_hybrid_route_total
     by path and reason: one host/device_cold, every other verify
     device/ok (no host/device_error, host/device_down, host/circuit_open),
     bls_device_circuit_state 0, every BLS path kernel, fq_mont_mul and
     msm_fixed launched. Then the device ledger, reset at the phase's
     start: a state root and process_epoch at 2^12 validators book the
     tree_hash and epoch tenants; bls, tree_hash and epoch each closed an
     interval, busy + contended + idle equals the ledger's window on the
     one chip (relative 1e-6); the snapshot per workload printed;
  9. calibrate: `python -m lighthouse_tpu_torch autotune calibrate` as
     cli.main on the card (6 reps, bench_fixtures.npz: buckets (4, 128),
     (16, 128), (64, 128), (512, 128) and (4, 512), the MSM widths, the
     16384-leaf ladder), the launch counts and the autotune profiler reset
     before it: the profile's key, buckets, samples (reps + 1 each, none
     counted twice), stage programs, host reference, MSM width (every
     width's sum equal to the pure-Python sum) and ladder root (hashlib's)
     checked, the plan installed and read by msm_window() and the ladder's
     warm-up, every kernel of CALIBRATE_PATH launched; then the path
     kernels against their plain versions at (4, 128);
 10. attribution: observability.device.profile_stages(64, 128) and one
     gossip verify under device.attributed(): each stage's CUDA-event ms
     and its share of its bound, none above 1;
 11. ef_state: the 168 EF cases under tests/ef/vectors/minimal but
     ssz_static (156 state-transition cases, 12 shuffling) through the
     port's ef_runner on "torch" with real signatures, in 8 worker
     processes: each must pass, the path kernels must launch;
 12. block_mainnet: testing/block_fixtures.py's block (the mainnet preset
     with deneb from genesis, 2^14 validators, the block at slot 64 with
     128 attestations of 128 keys, the 512-key sync aggregate, the
     proposer signature and the RANDAO reveal: 131 sets at bucket
     (256, 512)), built on the host by a process started after the build
     phase, imported through slot.state_transition (VERIFY_BULK, "torch",
     the "device" hash backend) with the launch counts reset: the
     post-state root equal to the block's and to a NO_VERIFICATION
     import's, a copy with two attestations' signatures swapped rejected,
     one batch of 131 sets, the six path kernels, sha256_ladder and
     epoch_deltas launched; the import's wall time and its split (the
     slots with the epoch and the state roots, building the sets, the
     marshal, dispatch to verdict, the rest of the block, the post-state
     root); then every kernel of the path against its plain version at
     the path's shapes;
 13. beacon_chain: the same block through chain/beacon_chain.py's
     BeaconChain from the fixture's genesis ("torch", the "device" hash
     backend): the state-advance timer at slot 63, then gossip verify and
     process_block (130 sets at (256, 512), the signatures cached by
     block_mainnet's import) with the launch counts reset:
     the head, its state root (the block's and block_mainnet's), the
     store's block and state and the fork-choice head checked; a fresh
     chain rejects the swapped copy and keeps its anchor; 64 single
     attestations of slot 64 (one key each) in one batch at (64, 1), all
     verified, then deduped; on chains started from the block by
     from_checkpoint, one of them signed by a wrong key leaves 63 (the
     per-set fallback) and submit_attestation_batch gives the same
     verdicts; the walls split (the advance, per_slot_task, gossip verify,
     process_block: building the sets, marshal, dispatch to verdict, store
     writes, fork choice); every kernel of the path against its plain
     version at (256, 512) and (64, 1), the ladder and epoch_deltas at the
     path's widths;
 14. beacon_processor: on the same fixture, block and singles: the 64
     singles published as snappy-compressed SSZ on their attestation
     subnets through network/gossip.py's InProcessGossipRouter into a
     BeaconProcessor (its workers started, an AdmissionController on the
     chain's clock; the capacity scheduler forms the batches) whose batch
     runner is submit_attestation_batch on a chain started from the block,
     the verified singles into fork choice and an OperationPool: all 64
     processed and verified, none dropped, expired or shed, no processor
     error; the copy with the bad single through run_until_idle on a fresh
     chain: the batch fails and the per-set fallback keeps 63, only they
     reach the pool; observability.pipeline.run_probe and every pipeline
     stage in snapshot(); produce_block at slot 65 from the pool (the
     RANDAO reveal and the block signed in-process): its attestations
     cover exactly the 64 validators; its import through per_slot_task,
     verify_block_for_gossip and process_block on a chain over HotColdDB on
     two NativeKVStores (the g++ build, not the fallback), anchored at
     genesis: the head, its state root, the stored block, fsck_datadir
     clean after persist; the batches' sizes, the scheduler's decisions,
     the queue waits and the walls split; every BLS path kernel against
     its plain version at each bucket the phase ran that no earlier phase
     held, the ladder at its widths;
 15. bn: `python -m lighthouse_tpu_torch bn` run as cli.main on this
     thread ("torch", the "device" hash backend, a native store, free
     ports) from the fixture's genesis state with its genesis_time moved
     to one slot before the phase, the spec as a config.yaml, peer A (an
     in-process NetworkNode on its own chain) as its static peer: peer A
     publishes 64 single attestations of slot 0 over gossip (TCP,
     gossipsub), which the node's processor verifies on the card, all of
     them reaching its op pool; block 1 produced over the Beacon HTTP API
     (GET /eth/v3/validator/blocks/1), signed and published (POST
     /eth/v2/beacon/blocks), imported as head and packing the 64
     validators, the API's head root and state root, peer count and a
     /metrics scrape; peer B range-syncs it over Req/Resp to the same
     head; SIGTERM: exit 0, the chain persisted, fsck_datadir clean; the
     path kernels against their plain versions at each bucket no earlier
     phase held, the ladder at its widths;
 16. each kernel's device time from torch.profiler at the four buckets
     and (256, 512) (prepare's three launches apart), beside phase 3's
     CUDA-event times, which take in the host's time where a wrapper's
     Python outlasts its kernel, and the gossip bucket's sums per stage
     beside the attribution phase's event ms; the MSM kernels' at the KZG
     path's full width; fq_mont_mul's at each size of the field phase;
     the tree-hash and epoch kernels' at their paths' width and the block
     path's; the card's busy share of one KZG batch verify; last, of one
     more import through BeaconChain, of the produced block's through
     BeaconChain on the native store and of one more through
     state_transition (their signatures cached).
The last two lines are the kernel table and the device line. To time
another checkout's kernels with this script, copy it into that checkout's
root and run it there.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

try:   # outside a checkout main() says so and exits 2
    from lighthouse_tpu_torch.crypto.torchbls.costs import (
        ELEMENT_BYTES, HBM_BYTES_PER_S, IMAD_PER_FQ_MUL, INT32_PER_S, bound_ms, bytes_needed,
        fq_products_easy_part, fq_products_h2c, fq_products_hard_part, fq_products_miller,
        fq_products_miller_batch, fq_products_pairs, fq_products_prepare, int_ops_inverse, leaves,
    )
except ImportError:
    pass

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "bench_fixtures.npz")
N_SETS, N_PKS = 64, 128          # gossip batch cap x target committee size
FIELD_N = 1 << 20
FIELD_SIZES = (130, 1 << 14, 1 << 20, 1 << 22)    # a * b sizes of the field sweep
INTERCHANGE_BYTES = 192           # an Fq element as the port passes it: 24 int64 limbs
LATENCY_ITERS = 4096              # dependent products per chain in product_latency
VERIFY_REPEATS = 3                # verifies of the valid batch; the median is reported
PIPELINED = 8                     # submissions of the pipelined phase
EF_BLS = os.path.join(ROOT, "tests", "ef", "vectors", "general", "phase0", "bls")
# kernels each driven path must launch
MAIN_PATH = ("stage_prepare", "hash_to_g2", "stage_pairs", "miller_loop_batch",
             "miller_loop_product", "final_exp_easy_part", "final_exp_hard_part")
AGGREGATE_PATH = ("fq_mont_mul", "hash_to_g2", "stage_pairs", "miller_loop_batch",
                  "miller_loop_product", "final_exp_easy_part", "final_exp_hard_part")
KZG_PATH = ("msm_precompute", "msm_fixed", "msm_varying", "miller_loop_batch",
            "miller_loop_product", "final_exp_easy_part", "final_exp_hard_part")
KZG_N, KZG_BLOBS = 4096, 6         # FIELD_ELEMENTS_PER_BLOB (mainnet), MAX_BLOBS_PER_BLOCK (Deneb)
KZG_VERIFY_REPEATS = 5            # batch verifies; the median is reported
MSM_SUBSET = 256                  # points of the kernels' subset check
INV_ITERS = 15                    # inversions per chain in product_latency (odd: x -> x^-1)
INV_N = 1 << 16                   # random elements of the inversion check
# the tree-hash and epoch paths: the port's state_root_1m loadgen scenario
# (lighthouse_tpu_torch/loadgen/scenarios.py): the mainnet registry, 4
# slots of 8 validator and 32 balance writes each, seed 0xC0FFEE
STATE_ROOT_SCENARIO, STATE_ROOT_N = "state_root_1m", 1 << 20
EPOCH_N, EPOCH_SEED = 1 << 20, 0xE90C
STATE_ROOT_PATH, EPOCH_PATH = ("sha256_ladder",), ("epoch_deltas",)
PROBE_WAIT_S = 300                # the hybrid router's probe and urgent warm, at most
HYBRID_EXTRA = ("fq_mont_mul", "msm_fixed")   # AggregateVerify's and KZG's kernels in the hybrid phase
HYBRID_STATE_N = 1 << 12          # the hybrid phase's ledger step: above the hash and epoch thresholds
LADDER_WIDTHS = (1, 2, 63, 64, 65, 1023, 1024, 1025)
MSG_LENGTHS, MSG_N = (0, 55, 56, 63, 64, 65, 119, 128), 1 << 14
# the calibrator's default reps, the buckets of its sweep over
# bench_fixtures.npz and the kernels its path launches
CALIBRATE_REPS = 6
CALIBRATE_BUCKETS = ((4, 128), (16, 128), (64, 128), (512, 128), (4, 512))
CALIBRATE_PATH = MAIN_PATH + ("msm_varying", "sha256_ladder")
# the EF state-transition vectors (every case under minimal but ssz_static)
# on "torch", in worker processes of their own
EF_STATE_ROOT = os.path.join(ROOT, "tests", "ef", "vectors")
# 156 state-transition cases and 12 shuffling, in a process for each of the
# host's 8 cores (the script's own process waits meanwhile)
EF_STATE_CASES, EF_STATE_WORKERS = 168, 8
# block import at mainnet width (testing/block_fixtures.py): 2^14
# validators, 128 attestations of 128 keys, the 512-key sync aggregate,
# the proposer signature and the RANDAO reveal in one batch verify
BLOCK_PATH = MAIN_PATH + ("sha256_ladder", "epoch_deltas")
BLOCK_SETS, BLOCK_BUCKET = 131, (256, 512)
FIXTURE_WAIT_S = 900              # the block fixture's build, started with the script
# the same block through chain/beacon_chain.py's BeaconChain (gossip
# verify, then process_block with the proposal verified: 130 sets), then
# SINGLES unaggregated attestations of slot 64 in one gossip batch (one
# key each, 16 of each of the slot's 4 committees), signed on SIGN_WORKERS
# processes; the SINGLES_BAD-th signed by the wrong key in a second batch
BEACON_CHAIN_PATH = MAIN_PATH + ("sha256_ladder", "epoch_deltas")
PROCESSOR_PATH = MAIN_PATH + ("sha256_ladder",)
PRODUCE_PATH = ("sha256_ladder",)  # produce_block: the post-state root, no signature check
PROCESSOR_DRAIN_S = 300           # the live processor's drain: 64 decompressions, at most
PROBE_ITEMS = 8                   # observability.pipeline.run_probe's batch
CHAIN_SETS, SINGLES, SINGLES_BAD, SIGN_WORKERS = 130, 64, 17, 8
# `python -m lighthouse_tpu_torch bn` on the same registry: peer A's SINGLES
# gossip singles of slot 0, block 1 produced and published over HTTP, peer
# B's range sync; every wait of the phase BN_WAIT_S at most
BN_PATH = MAIN_PATH + ("sha256_ladder",)
BN_WAIT_S = 300

# 32-bit instructions of one SHA-256 compression as csrc/sha256.cu writes
# it, at Hopper's three-input LOP3 and IADD3: a round is 14 (Sigma1 and
# Sigma0: 3 funnel shifts and a LOP3 each; ch and maj: a LOP3 each; t1: 2
# IADD3; a: an IADD3; e: an IADD), a schedule word 10 (sigma0 and sigma1:
# 2 funnel shifts, a shift and a LOP3 each; the sum: 2 IADD3), the state's
# final add 8. A merkle node is a message block and the pad block, whose
# schedule is constant.
SHA_ROUND_OPS, SHA_SCHEDULE_OPS = 14, 10
SHA_BLOCK_OPS = 64 * SHA_ROUND_OPS + 48 * SHA_SCHEDULE_OPS + 8
SHA_NODE_OPS = SHA_BLOCK_OPS + 64 * SHA_ROUND_OPS + 8
# epoch_deltas per validator, at least: 10 64-bit products (4 32-bit
# instructions each), 7 divisions by an epoch scalar (as a product by its
# reciprocal and a correction, 8 each) and 7 selects (2 each)
EPOCH_OPS = 10 * 4 + 7 * 8 + 7 * 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list[dict]:
    """Per entry kernel: registers, static shared memory, stack frame and
    spills."""
    import re

    props: dict = {}
    entries: list = []
    current = None
    last_fn = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = {"entry": m.group(1)}
            entries.append(current)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            last_fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and last_fn:
            props[last_fn] = tuple(int(g) for g in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            current["registers"] = int(m.group(1))
            current["smem_bytes"] = int(smem.group(1)) if smem else 0
    for e in entries:
        stack, st, ld = props.pop(e["entry"], (0, 0, 0))
        e.update(stack_bytes=stack, spill_store_bytes=st, spill_load_bytes=ld)
    # the out-of-line device functions (team.cuh's interpreter among them)
    entries += [{"function": name, "stack_bytes": s, "spill_store_bytes": st, "spill_load_bytes": ld}
                for name, (s, st, ld) in sorted(props.items())]
    return entries


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(kernel_out, plain_out) -> tuple[bool, int]:
    """(torch.equal on every output, max |kernel - plain| over them)."""
    import torch

    ks, ps = leaves(kernel_out), leaves(plain_out)
    if len(ks) != len(ps):
        return False, -1
    equal = all(torch.equal(k, p) for k, p in zip(ks, ps))
    err = max((int((k.long() - p.long()).abs().max()) if k.numel() else 0
               for k, p in zip(ks, ps)), default=0)
    return equal, err


# The MSM kernels' work on this run's data: a doubling 7 Fq products, a
# general addition 16, an addition with an identity operand none; the
# affine conversion one inversion (its product by R^3 beside the GCD,
# int_ops_inverse), Z^-2, Z^-3, x, y and the two products out of Montgomery
# form, 6 more. The bounds of msm_fixed and msm_varying count the least of
# the MSM methods in least_msm_work, not the kernels' own method, whose
# count (kernel_fq_products) stands beside it in the schedule line.
MSM_AFFINE_PRODUCTS = 1 + 6


def fq_products_msm_precompute(inf_mask) -> int:
    """Per live point its Montgomery conversion (2) and the 15 x 16
    doublings from row 0 to row 15, each row a point of the output."""
    live = int((inf_mask == 0).sum())
    return live * (2 + 15 * 16 * 7)


DOUBLING_ROUNDS = 3               # msm.cu join_dbl: dependent product rounds of a doubling


def cu_defines(path: str) -> dict:
    """The `#define NAME expr` lines of a CUDA source whose expression is
    integer arithmetic on earlier names, evaluated in order (C's division
    of nonnegative integers as Python's //)."""
    import re

    consts: dict = {}
    with open(path) as f:
        text = f.read()
    for name, expr in re.findall(r"^#define (\w+) ([\w ()*/+-]+?)\s*(?://.*)?$", text, re.M):
        try:
            consts[name] = eval(expr.replace("/", "//"), {"__builtins__": {}}, dict(consts))
        except NameError:
            pass
    return consts


def window_digits(scalars, bits: int, c: int):
    """(n, ceil(bits / c)) c-bit digits of the scalars, least significant
    window first, as int64."""
    import numpy as np

    windows = -(-bits // c)
    if bits <= 62:
        ks = np.asarray(scalars, dtype=np.int64)[:, None]
        return (ks >> (c * np.arange(windows))) & ((1 << c) - 1)
    return np.array([[(k >> (c * w)) & ((1 << c) - 1) for w in range(windows)] for k in scalars],
                    dtype=np.int64).reshape(len(scalars), windows)


def least_msm_work(scalars, bits: int) -> tuple[int, dict]:
    """The Fq products of sum_i k_i P_i over points in general position with
    these nonzero scalars (< 2^bits), by the cheaper of two methods at the
    best window c of 1..16 bits, counted on this run's digits:
      bucket (Pippenger): per window an addition per nonzero digit into
        its bucket, the first into each bucket free; the buckets' running
        sums, top - 1 more; then the windows joined from the top, c
        doublings and an addition each;
      interleaved (Straus): one chain of c doublings per window for all
        points, an addition per nonzero digit (the first free), and per
        point a table of 2^c - 1 multiples (2P a doubling, the rest
        additions; none at c = 1).
    Returns the products and the method and window that give them."""
    import numpy as np

    ks = [k for k in scalars if k]
    if not ks:
        return 0, {"method": "none", "window": 0}
    best = None
    for c in range(1, 17):
        d = window_digits(ks, bits, c)
        nnz = (d != 0).sum(axis=0)
        top_window = int(np.nonzero(nnz)[0].max())
        distinct = np.array([len(np.unique(col[col != 0])) for col in d.T])
        top = d.max(axis=0)
        live = nnz > 0
        bucket_adds = int((nnz - distinct)[live].sum() + (distinct - 1)[live].sum()
                          + (top - 1)[live].sum()) + int(live.sum()) - 1
        bucket = 16 * bucket_adds + 7 * c * top_window
        table = 0 if c == 1 else len(ks) * (7 + 16 * ((1 << c) - 3))
        straus = 16 * (int(nnz.sum()) - 1) + 7 * c * top_window + table
        for method, products in (("bucket", bucket), ("interleaved", straus)):
            if best is None or products < best[0]:
                best = (products, {"method": method, "window": c})
    return best


def join_products(live) -> int:
    """msm_join_kernel's Fq products over its terms, each the identity or
    not: per level, each pair's upper term doubled 2^(level - 1) times
    (none for the identity) and added to the lower one."""
    total, span = 0, 1
    while len(live) > 1:
        pairs = list(zip(live[0::2], live[1::2]))
        total += sum(7 * span * hi + 16 * (lo and hi) for lo, hi in pairs)
        live, span = [lo or hi for lo, hi in pairs], 2 * span
    return total


def fq_products_msm_fixed(tz, bits) -> tuple[int, int, dict]:
    """The comb MSM over its live lanes (the table point finite, the chunk
    nonzero): the least work of their 16-bit chunks (least_msm_work) and
    the affine conversion; beside it the kernel's own count: per 8-bit
    window an addition per lane into its bucket (the first free), per
    window and bit the sum of the nonempty buckets with that bit, the
    join of the 16 terms. Returns (least, own, the least's method)."""
    from collections import Counter

    import torch

    weights = 1 << torch.arange(bits.shape[1] - 1, -1, -1, device=bits.device)
    chunks = (bits.long() * weights).sum(dim=1)
    live = (tz != 0).any(dim=1) & (chunks != 0)
    values = chunks[live].tolist()
    least, method = least_msm_work(values, bits.shape[1])
    own, terms = 0, []
    for w in range(2):
        buckets = Counter(d for d in ((c >> (8 * w)) & 0xFF for c in values) if d)
        own += 16 * sum(n - 1 for n in buckets.values())
        for b in range(8):
            m = sum(1 for d in buckets if d >> b & 1)
            own += 16 * max(m - 1, 0)
            terms.append(m > 0)
    own += join_products(terms)
    return least + MSM_AFFINE_PRODUCTS, own + MSM_AFFINE_PRODUCTS, method


def fq_products_msm_varying(mask, scalars) -> tuple[int, int, dict]:
    """The varying-base MSM over its live lanes (masked in, scalar
    nonzero): per lane its Montgomery conversion (2), the least work of
    the 256-bit scalars (least_msm_work) and the affine conversion; beside
    it the kernel's own count: per lane the product by beta, per bit of
    the GLV halves the sum of the slots with that bit, the join of the 128
    windows. Returns (least, own, the least's method)."""
    from lighthouse_tpu_torch.crypto.torchbls.msm import GLV_LAMBDA

    live = [k for on, k in zip(mask.tolist(), scalars) if on and k]
    least, method = least_msm_work(live, 256)
    halves = [h for k in live for h in divmod(k, GLV_LAMBDA)]
    own, terms = len(live), []
    for j in range(128):
        m = sum(1 for h in halves if h >> j & 1)
        own += 16 * max(m - 1, 0)
        terms.append(m > 0)
    own += join_products(terms)
    fixed = 2 * len(live) + MSM_AFFINE_PRODUCTS
    return least + fixed, own + fixed, method


def field_floors(n: int, operands: int) -> dict:
    """The floors of n Montgomery products with `operands` inputs (1: by
    R^2) and one output, ms: the interchange's bytes and the elements' 48
    bytes over HBM's rate, and the IMADs over the integer rate."""
    moved = (operands + 1) * n
    return {"interchange_ms": moved * INTERCHANGE_BYTES / HBM_BYTES_PER_S * 1e3,
            "bytes48_ms": moved * ELEMENT_BYTES / HBM_BYTES_PER_S * 1e3,
            "imad_ms": n * IMAD_PER_FQ_MUL / INT32_PER_S * 1e3}


# ------------------------------------------------------------ product latency


def product_latency(dev) -> dict:
    """csrc/latency.cu's chains of LATENCY_ITERS dependent Montgomery
    products (CUDA events, one launch each): us per product of one thread
    on the CIOS product with 64-bit carries and on fq.cuh's carry-chain
    fp_mul, the products per us of one warp running 32 chains, and us per
    level of a 16-lane team (a product per lane, shared memory, __syncwarp);
    and us per level of team.cuh's interpreter on G2 doublings (3 product
    levels and an output pass each), with lane 0's cycles per level split
    by rounds.cuh's cycle hook into the operand forms' loads and sums and
    their reductions, fp_mul, the slot store and the __syncwarp (clock64).
    Each chain's result is held against the plain mont_mul chain."""
    import torch

    from lighthouse_tpu_torch.crypto.torchbls import kernels as K
    from lighthouse_tpu_torch.crypto.torchbls import limbs as lb

    lib = K.latency_library().lib
    gen = torch.Generator(device=dev).manual_seed(20261018)
    xs = torch.randint(0, 1 << 16, (32, lb.NL), generator=gen, device=dev)
    ys = torch.randint(0, 1 << 16, (32, lb.NL), generator=gen, device=dev)
    xs[:, -1] = 0
    ys[:, -1] = 0
    out = torch.empty_like(xs)
    res, got = {}, {}
    for variant, name, lanes in ((0, "cios64_chain", 1), (1, "carry_chain", 1),
                                 (2, "warp_32_chains", 32), (3, "team_level", 16)):
        def launch(v=variant):
            err = lib.lh_product_latency(v, LATENCY_ITERS, xs.data_ptr(), ys.data_ptr(),
                                         out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"product_latency variant {v}: CUDA error {err}")
        res[name] = cuda_ms(launch, 3) * 1e3 / LATENCY_ITERS
        got[name] = out[:lanes].clone()
    # G2 doublings through the team interpreter
    from lighthouse_tpu_torch.crypto.torchbls import curve_ops as co
    from lighthouse_tpu_torch.crypto.torchbls import team as tm

    dbls = LATENCY_ITERS // 8
    levels = dbls * tm.levels(tm.point_programs("g2")["dbl_AB"])

    def launch_program():
        err = lib.lh_product_latency(4, dbls, xs.data_ptr(), ys.data_ptr(), out.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"product_latency variant 4: CUDA error {err}")
    res["program"] = cuda_ms(launch_program, 3) * 1e3 / levels
    got["program"] = out[:6].clone()
    # where a level's cycles go (lane 0, clock64 at the cycle hook's marks)
    err = lib.lh_product_latency(5, dbls, xs.data_ptr(), ys.data_ptr(), out.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err:
        raise SystemExit(f"product_latency variant 5: CUDA error {err}")
    cyc = [int(c) for c in out.view(-1)[:6].tolist()]
    split = {k: c / levels for k, c in zip(("form_terms", "form_reduce", "fp_mul", "store",
                                            "syncwarp", "all"), cyc)}
    # one Fq inversion: the Fermat chain (lh_inverse variant 0) against
    # fq.cuh's binary GCD (variant 1), in one thread and in a warp of 32
    # threads with different inputs, INV_ITERS inversions x <- x^-1 each
    us_inverse = {}
    for variant, alg in ((0, "fermat"), (1, "gcd")):
        for lanes, who in ((1, "thread"), (32, "warp")):
            def launch_inverse(v=variant, n=lanes):
                err = lib.lh_inverse(v, n, INV_ITERS, xs.data_ptr(), out.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"lh_inverse variant {v}: CUDA error {err}")
            us_inverse[f"{alg}_{who}"] = cuda_ms(launch_inverse, 3) * 1e3 / INV_ITERS
            got[f"inverse_{alg}_{who}"] = out[:lanes].clone()
    pt = (xs[0:2], xs[2:4], xs[4:6])
    for _ in range(dbls):
        pt = co.jac_double(pt, co.FQ2_OPS)
    # the plain chains: x <- x y per lane; the team: x_l <- x_l x_(l+1 mod 16)
    x, t = xs.clone(), xs[:16].clone()
    for _ in range(LATENCY_ITERS):
        x = lb.mont_mul(x, ys)
        t = lb.mont_mul(t, torch.roll(t, -1, dims=0))
    equal = {"cios64_chain": torch.equal(got["cios64_chain"], x[:1]),
             "carry_chain": torch.equal(got["carry_chain"], x[:1]),
             "warp_32_chains": torch.equal(got["warp_32_chains"], x),
             "team_level": torch.equal(got["team_level"], t),
             "program": torch.equal(got["program"], torch.cat(pt))}
    xinv = lb.mont_inv(xs)                  # INV_ITERS is odd: each chain ends at x^-1
    for k in us_inverse:
        equal[f"inverse_{k}"] = torch.equal(got[f"inverse_{k}"], xinv[:got[f"inverse_{k}"].shape[0]])
    return {"us_per_product_cios64": res["cios64_chain"],
            "us_per_product_carry_chain": res["carry_chain"],
            "warp_products_per_us": 32 / res["warp_32_chains"],
            "us_per_warp_step_32_chains": res["warp_32_chains"],
            "us_per_team_level": res["team_level"],
            "us_per_program_level": res["program"],
            "cycles_per_program_level": split,
            "us_per_inverse": us_inverse, "inverse_iters": INV_ITERS,
            "iters": LATENCY_ITERS, "equal": equal}


def inverse_check(dev) -> dict:
    """fq.cuh's binary-GCD inversion against the Fermat chain it replaced
    (csrc/latency.cu's lh_inverse, variants 1 and 0, a thread per element)
    on INV_N seeded random elements and the edge inputs 0, 1, p - 1, p - 2,
    R mod p, R^2 mod p, (2^381 - k) mod p and the powers of two below
    2^381 (2^380 takes the most divsteps): the count of elements where they
    differ, the GCD against the plain limbs.mont_inv, and each variant's
    ms for the whole batch (CUDA events)."""
    import numpy as np
    import torch

    from lighthouse_tpu_torch.crypto.bls381.constants import P
    from lighthouse_tpu_torch.crypto.torchbls import kernels as K
    from lighthouse_tpu_torch.crypto.torchbls import limbs as lb

    lib = K.latency_library().lib
    gen = torch.Generator(device=dev).manual_seed(20261019)
    x = torch.randint(0, 1 << 16, (INV_N, lb.NL), generator=gen, device=dev)
    x[:, -1] = torch.randint(0, 0x1A01, (INV_N,), generator=gen, device=dev)    # < p
    r = (1 << 384) % P
    edges = ([0, 1, P - 1, P - 2, r, r * r % P] + [((1 << 381) - k) % P for k in (1, 2, 3)]
             + [1 << k for k in range(381)])
    x = torch.cat([x, torch.as_tensor(np.stack([lb.pack(v) for v in edges]).astype(np.int64),
                                      device=dev)])
    outs, ms = {}, {}
    for variant, alg in ((0, "fermat"), (1, "gcd")):
        out = torch.empty_like(x)

        def launch(v=variant, o=out):
            err = lib.lh_inverse(v, x.shape[0], 1, x.data_ptr(), o.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"lh_inverse variant {v}: CUDA error {err}")
        ms[alg] = cuda_ms(launch, 3)
        outs[alg] = out
    differ = int((outs["fermat"] != outs["gcd"]).any(dim=-1).sum())
    return {"n": INV_N, "edges": len(edges), "differ": differ,
            "gcd_equal_plain": torch.equal(outs["gcd"], lb.mont_inv(x)), "ms": ms}


# each wrapper's hand-written kernels, by the names torch.profiler gives them
KERNEL_FUNCTIONS = {
    "fq_mont_mul": ("fq_mont_mul_kernel", "fq_to_mont_kernel"),
    "stage_prepare": ("prepare_aggregate", "prepare_scale", "prepare_sig_sum"),
    "stage_pairs": ("pairs_kernel",),
    "miller_loop_product": ("miller_batch_kernel", "tree_level_kernel"),
    "miller_loop_batch": ("miller_batch_kernel",),
    "final_exp_hard_part": ("hard_part_kernel",),
    "hash_to_g2": ("h2c_kernel",),
    "final_exp_easy_part": ("easy_part_kernel",),
    "msm_precompute": ("msm_precompute_kernel",),
    "msm_fixed": ("msm_hist_kernel", "msm_scatter_kernel", "msm_level_kernel",
                  "msm_join_kernel"),
    "msm_varying": ("msm_recode_kernel", "msm_level_kernel", "msm_join_kernel"),
    "sha256_ladder": ("sha256_level_kernel",),
    "sha256_msgs": ("sha256_msgs_kernel",),
    "epoch_deltas": ("epoch_deltas_kernel",),
}


def kernel_registry() -> dict:
    """Every kernel of the port, both libraries: name -> (wrapper, plain
    version, source path in the repository, the JAX program it replaces)."""
    from lighthouse_tpu_torch.crypto.torchbls import kernels as K
    from lighthouse_tpu_torch.torchhash import kernels as HK

    return {name: (w, p, f"lighthouse_tpu_torch/{pkg}/csrc/{src}", rep)
            for pkg, reg in (("crypto/torchbls", K.KERNELS), ("torchhash", HK.KERNELS))
            for name, (w, p, src, rep) in reg.items()}


def reset_launches() -> None:
    from lighthouse_tpu_torch.crypto.torchbls import kernels as K
    from lighthouse_tpu_torch.torchhash import kernels as HK

    K.reset_launches()
    HK.reset_launches()


def profile_ms(name, args, reps: int = 3) -> dict:
    """Device ms per call of the kernels that the wrapper `name` launches on
    args, from torch.profiler (mean over reps calls): its hand-written
    kernels by name and in all (kernel_ms), and the torch kernels of the
    wrapper's own tensor work (wrapper_torch_ms), apart from the host time
    that CUDA events around back-to-back calls also take in."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wrapper = kernel_registry()[name][0]
    wrapper(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            wrapper(*args)
        torch.cuda.synchronize()
    ours, other = {}, 0.0
    for ev in prof.key_averages():
        # "msm_join_kernel(...)", or for a template "void name<...>(...)"
        key = ev.key.split("(")[0].split("<")[0].removeprefix("void ")
        dev_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if key in KERNEL_FUNCTIONS[name]:
            ours[key] = dev_us / 1e3 / reps
        elif getattr(ev, "device_type", None) == DeviceType.CUDA:
            other += dev_us / 1e3 / reps
    return {"kernel_ms": sum(ours.values()), "split": ours, "wrapper_torch_ms": other}


def device_share(fn) -> dict:
    """One call of fn under torch.profiler: its wall ms (synchronised), the
    device ms of every kernel and copy it ran on the card, and the share of
    the wall the card was busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    on_card = [ev for ev in prof.key_averages()
               if getattr(ev, "device_type", None) == DeviceType.CUDA]
    busy = sum((getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0))
               for ev in on_card) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "device_busy_share": busy / wall_ms,
            "device_launches": sum(ev.count for ev in on_card)}


# ------------------------------------------------------------ field phase


def random_elements(gen, n: int, dev):
    """n seeded random Fq elements below p, as (n, NL) int64 limbs."""
    import torch

    from lighthouse_tpu_torch.crypto.torchbls import limbs as lb

    x = torch.randint(0, 1 << 16, (n, lb.NL), generator=gen, device=dev)
    x[:, -1] = torch.randint(0, 0x1A01, (n,), generator=gen, device=dev)    # < p
    return x


def plain_in_chunks(a, b=None, chunk: int = 65536):
    """fq_mont_mul's plain version over chunks of rows (its intermediates
    grow with the rows)."""
    import torch

    from lighthouse_tpu_torch.crypto.torchbls import kernels as K

    return torch.cat([K.fq_mont_mul_plain(a[i:i + chunk], None if b is None else b[i:i + chunk])
                      for i in range(0, a.shape[0], chunk)])


def field_phase(dev) -> list:
    """fq_mont_mul against its plain version: a * b on FIELD_N seeded
    random pairs and every pair of the edge operands, by R^2 on FIELD_N
    elements, and a * b at each of FIELD_SIZES (prefixes of the seeded
    pairs); each case's CUDA-event ms and floors, beside the CUDA-event ms
    of one torch op that moves the same bytes (torch.add of the operands; a
    clone by R^2): the rate the card's memory gives a plain streaming op.
    Returns the cases, (form, n, args), for the device times at the end."""
    import numpy as np
    import torch

    from lighthouse_tpu_torch.crypto.bls381.constants import P
    from lighthouse_tpu_torch.crypto.torchbls import kernels as K
    from lighthouse_tpu_torch.crypto.torchbls import limbs as lb

    gen = torch.Generator(device=dev).manual_seed(20261016)
    big = max(FIELD_SIZES)
    xs, ys = random_elements(gen, big, dev), random_elements(gen, big, dev)
    # every pair of the edge operands: 0, 1, p - 1, p - 2, R mod p, R^2 mod
    # p, (2^381 - k) mod p (inputs are fully reduced)
    r_mont = (1 << 384) % P
    edges = [0, 1, P - 1, P - 2, r_mont, r_mont * r_mont % P] + [((1 << 381) - k) % P
                                                                  for k in (1, 2, 3)]
    e = torch.as_tensor(np.stack([lb.pack(v) for v in edges]).astype(np.int64), device=dev)
    ne = len(edges)
    a = torch.cat([xs[:FIELD_N], e.repeat_interleave(ne, dim=0)])
    b = torch.cat([ys[:FIELD_N], e.repeat(ne, 1)])
    field_equal = torch.equal(K.fq_mont_mul(a, b), plain_in_chunks(a, b))
    r2 = xs[:FIELD_N]
    r2_equal = torch.equal(K.fq_mont_mul(r2), plain_in_chunks(r2))
    emit({"phase": "field", "n": FIELD_N, "edge_pairs": ne * ne, "equal": field_equal,
          "ms": cuda_ms(lambda: K.fq_mont_mul(a, b), 10), "r2_n": FIELD_N, "r2_equal": r2_equal})
    if not (field_equal and r2_equal):
        raise SystemExit("fq_mont_mul disagrees with the plain mont_mul")

    sweep = [("a*b", n, (xs[:n], ys[:n])) for n in FIELD_SIZES]
    sweep_equal = [torch.equal(K.fq_mont_mul(*args), plain_in_chunks(*args)) for _f, _n, args in sweep]
    cases = [("a*b", a.shape[0], (a, b)), ("r2", FIELD_N, (r2,))] + sweep
    rows = []
    for form, n, args in cases:
        ms = cuda_ms(lambda: K.fq_mont_mul(*args), 20)
        # a plain elementwise op over the same bytes: what streaming gets
        stream_ms = cuda_ms((lambda: torch.add(*args)) if len(args) == 2 else args[0].clone, 20)
        floors = field_floors(n, len(args))
        rows.append({"form": form, "n": n, "ms": ms, "stream_ms": stream_ms, **floors,
                     "share_of_interchange_floor": floors["interchange_ms"] / ms})
    emit({"phase": "field_sizes", "sweep_equal": sweep_equal, "cases": rows})
    if not all(sweep_equal):
        raise SystemExit("fq_mont_mul disagrees with the plain mont_mul in the field sweep")
    return cases


def emit_field_device_ms(cases) -> None:
    """fq_mont_mul's device ms (torch.profiler) at each case of the field
    phase, beside its floors."""
    rows = []
    for form, n, args in cases:
        d = profile_ms("fq_mont_mul", args)
        floors = field_floors(n, len(args))
        rows.append({"form": form, "n": n, "device_ms": d["kernel_ms"], "split": d["split"],
                     **floors, "share_of_interchange_floor": floors["interchange_ms"] / d["kernel_ms"]})
    emit({"phase": "field_device_ms", "cases": rows})


# ------------------------------------------------------------ MSM kernels


def msm_checks(dev, setup, blobs, cbs, pbs, backend) -> tuple[dict, dict]:
    """The three MSM kernels against their plain versions (torch.equal) at
    the KZG path's full width (msm_precompute on the setup's 4096 points,
    msm_fixed on their 65536 comb lanes with blob 0's scalars, with every
    lane's chunk equal, so that each window has one bucket, and with every
    chunk 0; msm_varying on the batch verify's C' and W' at every width,
    0, 2, 4, 5 and 6), on the first MSM_SUBSET points (and on them with
    every fourth point the identity), on the comb's edge scalars (0, 1, R,
    R - 1 on six points, one of them the identity, whose tables
    msm_precompute also makes), and on [P, -P] and
    [P, P] under equal scalars (their lanes in one bucket; comb, and
    varying at w = 4 and 0); the sums at full width against the fixture's
    commitment, C' and W' and the edge cases also against the pure-Python
    curve; a digit outside its width's range refused (msm.REFUSED). Each
    kernel's row: CUDA-event ms, the plain version's ms and the bound at
    full width; msm_precompute's team layout (teams, lanes, blocks, SMs
    covered, product rounds a point) on the schedule line. Returns the
    rows and the full-width arguments (for the profiler)."""
    import random

    import numpy as np
    import torch

    from lighthouse_tpu_torch.crypto import kzg
    from lighthouse_tpu_torch.crypto.bls381 import curve as pc
    from lighthouse_tpu_torch.crypto.bls381 import serde
    from lighthouse_tpu_torch.crypto.bls381.constants import R
    from lighthouse_tpu_torch.crypto.torchbls import kernels as K
    from lighthouse_tpu_torch.crypto.torchbls import limbs as lb
    from lighthouse_tpu_torch.crypto.torchbls import msm
    from lighthouse_tpu_torch.crypto.torchbls.backend import pack_ints_vec

    def host_msm(points, scalars):
        acc = None
        for pt, k in zip(points, scalars):
            if pt is not None and k % R:
                acc = pc.g1_add(acc, pc.g1_mul(pt, k % R))
        return acc

    def point_args(points):
        xs = pack_ints_vec([0 if pt is None else pt[0] for pt in points]).astype(np.int64)
        ys = pack_ints_vec([0 if pt is None else pt[1] for pt in points]).astype(np.int64)
        return (torch.as_tensor(xs, device=dev), torch.as_tensor(ys, device=dev),
                torch.as_tensor(np.array([pt is None for pt in points]), device=dev))

    checks = {name: [] for name in ("msm_precompute", "msm_fixed", "msm_varying")}
    failed, host_equal, plain_ms = [], [], {}
    no_host = object()                   # a case with no host sum (None is the identity)

    def check(name, case, args, want=no_host, timed=False):
        kout = K.KERNELS[name][0](*args)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pout = K.KERNELS[name][1](*args)
        torch.cuda.synchronize()
        if timed:
            plain_ms[name] = (time.perf_counter() - t1) * 1e3
        checks[name].append(compare(kout, pout))
        if not checks[name][-1][0]:
            failed.append(f"{name} {case}: plain")
        if want is not no_host:
            host_equal.append(msm.affine_result(*kout) == want)
            if not host_equal[-1]:
                failed.append(f"{name} {case}: curve")
        return kout

    # full width: the setup's points and their comb tables, blob 0's scalars
    g1 = setup.g1_lagrange
    pre_args = point_args(g1)
    full = msm.FixedBaseMSM(g1, dev)
    poly0 = kzg.blob_to_polynomial(blobs[0], setup)
    fixed_args = (*full._tables, full.bits_tensor(poly0))
    check("msm_precompute", "4096 points", pre_args, timed=True)
    check("msm_fixed", "blob 0", fixed_args, serde.g1_decompress(cbs[0]), timed=True)
    one_bucket = fixed_args[3].clone()
    one_bucket[:] = torch.tensor([(0xA5C3 >> (15 - b)) & 1 for b in range(16)], device=dev)
    check("msm_fixed", "every chunk 0xA5C3", (*full._tables, one_bucket))
    check("msm_fixed", "every chunk 0", (*full._tables, torch.zeros_like(one_bucket)), None)
    # the batch verify's two varying-base MSMs, C' and W', as g1_msm gets them
    captured = []
    real_g1_msm = backend.g1_msm

    def spy(points, scalars):
        captured.append((list(points), list(scalars)))
        return real_g1_msm(points, scalars)

    backend.g1_msm = spy
    try:
        if kzg.verify_blob_kzg_proof_batch(blobs, cbs, pbs, setup) is not True:
            raise SystemExit("the KZG batch verify failed while its MSMs were captured")
    finally:
        del backend.g1_msm
    var_args = {}
    for which, (points, scalars) in zip(("c_prime", "w_prime"), captured):
        want = host_msm(points, scalars)
        for w in (4, 0, 2, 5, 6):
            var_args[which, w] = backend.msm_inputs(points, scalars, w) + (w,)
            check("msm_varying", f"{which} w = {w}", var_args[which, w], want,
                  timed=(which, w) == ("c_prime", 4))
    # a digit outside its width's range (16 at w = 4 and in the bit form,
    # -1), on a live lane: the REFUSED sum, which affine_result raises on
    refusals = []
    for w, past in ((4, 16), (0, 16), (6, -1)):
        px, py, live, digits, _w = var_args["c_prime", w]
        digits = digits.clone()
        digits[1, 3] = past
        x, y, inf = K.msm_varying(px, py, live, digits, w)
        refusals.append(lb.unpack(x.cpu().numpy()) == msm.REFUSED and not bool(inf))
    if not all(refusals):
        failed.append(f"msm_varying refusals {refusals}")
    # the first MSM_SUBSET points: their tables and blob 0's first scalars,
    # then with every fourth point the identity
    sub_points = g1[:MSM_SUBSET]
    for case, points in (("256 points", sub_points),
                         ("256 points, a quarter the identity",
                          [None if i % 4 == 3 else pt for i, pt in enumerate(sub_points)])):
        sub = msm.FixedBaseMSM(points, dev)
        check("msm_precompute", case, point_args(points))
        check("msm_fixed", case, (*sub._tables, sub.bits_tensor(poly0[:MSM_SUBSET])))
    # the comb's edge scalars on six points (tests/test_jaxbls_msm.py's)
    rng = random.Random(0x115)
    six = [pc.g1_mul(pc.G1_GEN, rng.randrange(1, R)) for _ in range(5)]
    six.insert(2, None)
    check("msm_precompute", "six edge points, one the identity", point_args(six))
    edge = msm.FixedBaseMSM(six, dev)
    for k, want in ((0, None), (1, six[0]), (R, None), (R - 1, pc.g1_neg(six[0]))):
        check("msm_fixed", f"edge {k}", (*edge._tables, edge.bits_tensor([k] + [0] * 5)), want)
    # opposite and equal points under equal scalars, each pair's lanes in
    # one bucket: the complete add's P == -Q (the identity) and P == Q
    # (the doubling) branches in the sums
    k = rng.randrange(1, R)
    for case, pair in (("[P, -P]", [six[0], pc.g1_neg(six[0])]), ("[P, P]", [six[0], six[0]])):
        want = host_msm(pair, [k, k])
        comb = msm.FixedBaseMSM(pair, dev)
        check("msm_fixed", case, (*comb._tables, comb.bits_tensor([k, k])), want)
        for w in (4, 0):
            check("msm_varying", f"{case} w = {w}",
                  backend.msm_inputs(pair, [k, k], w) + (w,), want)

    # rows at full width
    full_args = {"msm_precompute": pre_args, "msm_fixed": fixed_args,
                 "msm_varying": var_args["c_prime", 4]}
    c_scalars = [k % R for k in captured[0][1]]
    c_scalars += [0] * (full_args["msm_varying"][0].shape[0] - len(c_scalars))
    products = {"msm_precompute": fq_products_msm_precompute(pre_args[2])}
    own, least_by = {}, {}
    products["msm_fixed"], own["msm_fixed"], least_by["msm_fixed"] = fq_products_msm_fixed(
        fixed_args[2], fixed_args[3])
    products["msm_varying"], own["msm_varying"], least_by["msm_varying"] = (
        fq_products_msm_varying(full_args["msm_varying"][2], c_scalars))
    int_ops = {"msm_fixed": int_ops_inverse(), "msm_varying": int_ops_inverse()}
    rows, schedule = {}, {}
    for name, args in full_args.items():
        wrapper = K.KERNELS[name][0]
        kout = wrapper(*args)
        ms = cuda_ms(lambda: wrapper(*args), 3)
        if name == "msm_varying":       # digits: a 256-bit scalar a lane
            moved = bytes_needed(args[:3]) + 32 * args[0].shape[0]
        else:
            moved = bytes_needed(args)
        bms, by = bound_ms(products[name], moved + bytes_needed(kout), int_ops.get(name, 0))
        results = checks[name]
        rows[name] = {"max_abs_err": max(e for _eq, e in results),
                      "equal": all(eq for eq, _e in results), "checks": len(results),
                      "ms": ms, "plain_ms": plain_ms[name], "bound_ms": bms, "bound_by": by}
        schedule[name] = {"fq_products": products[name], **(
            {"inverse_int_ops": int_ops[name]} if name in int_ops else {}), **(
            {"least_by": least_by[name], "kernel_fq_products": own[name]}
            if name in own else {})}
        emit({"phase": "kernel", "path": "kzg", "name": name, **rows[name]})
    # msm_precompute's teams at full width (msm.cu's defines)
    cu = cu_defines(os.path.join(ROOT, "lighthouse_tpu_torch", "crypto", "torchbls", "csrc",
                                 "msm.cu"))
    n_points = int(pre_args[0].shape[0])
    blocks = -(-n_points // cu["PRE_TEAMS"])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    schedule["msm_precompute"]["team_layout"] = {
        "teams": n_points, "lanes": cu["JOIN_LANES"], "blocks": blocks,
        "threads_per_block": cu["MSM_THREADS"], "sms_covered": min(blocks, sms), "sms": sms,
        "product_rounds_per_point": (cu["N_CHUNKS"] - 1) * cu["CHUNK_BITS"] * DOUBLING_ROUNDS}
    emit({"phase": "schedule", "path": "kzg", "kernels": schedule,
          "c_prime_terms": len(captured[0][0]), "w_prime_terms": len(captured[1][0]),
          "varying_buckets": [int(var_args["c_prime", 4][0].shape[0]),
                              int(var_args["w_prime", 4][0].shape[0])],
          "refusals": refusals, "host_checks": len(host_equal)})
    if failed:
        raise SystemExit(f"an MSM kernel disagrees with its plain version or the curve: {failed}")
    return rows, {**full_args, "w_prime": var_args["w_prime", 4]}


def kzg_phase(drive, launches, dev):
    """The KZG path: the fixture's 4096-point setup and 6 blobs through the
    public KZG API on the active (torch) backend, driven with the launch
    counts reset just before it (`drive`); then the tampered and swapped
    batches, the median of KZG_VERIFY_REPEATS batch verifies, the host
    parts of one, and msm_checks. Returns msm_checks' rows and arguments
    and a function that runs the batch verify once."""
    from lighthouse_tpu_torch.crypto import bls, kzg
    from lighthouse_tpu_torch.crypto.bls381 import serde
    from lighthouse_tpu_torch.utils import fixtures

    t0 = time.perf_counter()
    kz = fixtures.load_kzg(FIXTURES)
    setup = kzg.TrustedSetup(kz["g1_lagrange"], kz["g2_monomial"],
                             kzg._fr_roots_of_unity(len(kz["g1_lagrange"])))
    blobs, cbs, pbs = kz["blobs"], kz["commitments"], kz["proofs"]
    if setup.n != KZG_N or len(blobs) != KZG_BLOBS:
        raise SystemExit(f"KZG fixture is not {KZG_BLOBS} blobs at {KZG_N}")
    kzg_load_s = time.perf_counter() - t0
    kzg_s = {}

    def kzg_run():
        t = time.perf_counter()
        commits = [kzg.blob_to_kzg_commitment(b, setup) for b in blobs]
        kzg_s["commitments"] = time.perf_counter() - t
        t = time.perf_counter()
        proofs = [kzg.compute_blob_kzg_proof(b, cb, setup) for b, cb in zip(blobs, cbs)]
        kzg_s["proofs"] = time.perf_counter() - t
        t = time.perf_counter()
        batch = kzg.verify_blob_kzg_proof_batch(blobs, cbs, pbs, setup)
        kzg_s["batch_verify"] = time.perf_counter() - t
        t = time.perf_counter()
        single = kzg.verify_blob_kzg_proof(blobs[0], cbs[0], pbs[0], setup)
        kzg_s["single_verify"] = time.perf_counter() - t
        return commits, proofs, batch, single

    (commits, proofs, batch_ok, single_ok), kzg_path_s = drive("kzg", KZG_PATH, kzg_run)
    commits_equal = [c == serde.g1_decompress(cb) for c, cb in zip(commits, cbs)]
    proofs_equal = [p_ == serde.g1_decompress(pb) for p_, pb in zip(proofs, pbs)]
    flipped = bytearray(blobs[0])
    flipped[31] ^= 1                    # the low byte of field element 0
    tampered_ok = kzg.verify_blob_kzg_proof_batch([bytes(flipped)] + blobs[1:], cbs, pbs, setup)
    swapped_ok = kzg.verify_blob_kzg_proof_batch(blobs, cbs, [pbs[1], pbs[0]] + pbs[2:], setup)
    verify_s = []
    for _ in range(KZG_VERIFY_REPEATS):
        t0 = time.perf_counter()
        ok_again = kzg.verify_blob_kzg_proof_batch(blobs, cbs, pbs, setup)
        verify_s.append(time.perf_counter() - t0)
        if ok_again is not True:
            raise SystemExit("a repeated KZG batch verify failed")
    kzg_median = sorted(verify_s)[len(verify_s) // 2]
    # the batch verify's host work by part: the 12 decompressions (each
    # with its subgroup check) and the 6 challenges with their evaluations
    t0 = time.perf_counter()
    for b in cbs + pbs:
        serde.g1_decompress(b)
    decompress_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for b, cb in zip(blobs, cbs):
        kzg._evaluate_polynomial_in_evaluation_form(
            kzg.blob_to_polynomial(b, setup), kzg.compute_challenge(b, cb, setup), setup)
    evaluate_s = time.perf_counter() - t0
    emit({"phase": "kzg", "setup_points": setup.n, "blobs": len(blobs),
          "fixture_load_seconds": kzg_load_s, "commitments_equal": commits_equal,
          "proofs_equal": proofs_equal, "batch_verified": batch_ok, "single_verified": single_ok,
          "tampered_verified": tampered_ok, "swapped_verified": swapped_ok,
          "seconds": kzg_s, "path_seconds": kzg_path_s, "verify_seconds": verify_s,
          "verify_median_seconds": kzg_median, "blobs_per_s": len(blobs) / kzg_median,
          "host_parts_seconds": {"decompress_12": decompress_s, "challenge_evaluate_6": evaluate_s},
          "launches": launches["kzg"]})
    if not (all(commits_equal) and all(proofs_equal) and batch_ok is True and single_ok is True
            and tampered_ok is False and swapped_ok is False):
        raise SystemExit("the KZG path gave a wrong commitment, proof or verdict")
    if launches["kzg"]["msm_precompute"] != 1:
        raise SystemExit(f"msm_precompute launched {launches['kzg']['msm_precompute']} times "
                         "on the KZG path, want once")
    rows, args = msm_checks(dev, setup, blobs, cbs, pbs, bls.get_backend())
    return rows, args, lambda: kzg.verify_blob_kzg_proof_batch(blobs, cbs, pbs, setup)



# ------------------------------------------------------------ tree hash and epoch


def sync_timed(fn, *args):
    """(fn(*args), its wall ms) with the card synchronised on both sides."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def state_root_phase(drive, launches) -> tuple:
    """The state_root path: the port's loadgen run_state_root_scenario on
    the state_root_1m scenario (lighthouse_tpu_torch/loadgen/scenarios.py)
    on the "device" hash backend, driven with the launch counts reset
    (`drive`), its fixture not cached on disk. Checks the roots distinct,
    the last equal to uncached_state_root (a host hashlib rehash of a copy,
    fresh tree cache), the balances conserved (the report's conservation
    block), the routes (device/ok, no host/device_error); times the host
    hashlib ladder over the validators' roots (the reference's "host"
    route) as the yardstick. Returns the validators' roots, the ladder's
    leaves, and the host ladder's root over them."""
    import numpy as np

    from lighthouse_tpu_torch.loadgen.scenarios import get_state_root_scenario
    from lighthouse_tpu_torch.loadgen.state_root import run_state_root_scenario
    from lighthouse_tpu_torch.ssz import tree_cache as tc
    from lighthouse_tpu_torch.testing import state_fixtures as fx
    from lighthouse_tpu_torch.torchhash import router

    sc = get_state_root_scenario(STATE_ROOT_SCENARIO, hash_backend="device")
    router.set_hash_backend("device")
    # the scenario's build (not cached on disk: built, as a node holds it)
    # and its ground truth, timed; the final state kept
    seen, build, uncached = {}, fx.build_synthetic_state, fx.uncached_state_root

    def timed_build(*args, **kwargs):
        t = time.perf_counter()
        out = build(*args, cache=False, **kwargs)
        seen["build_s"] = time.perf_counter() - t
        return out

    def timed_uncached(types, state):
        t = time.perf_counter()
        seen["truth"] = uncached(types, state)
        seen["uncached_s"], seen["types"], seen["final"] = time.perf_counter() - t, types, state
        return seen["truth"]

    fx.build_synthetic_state, fx.uncached_state_root = timed_build, timed_uncached
    try:
        report, path_s = drive("state_root", STATE_ROOT_PATH, lambda: run_state_root_scenario(sc))
    finally:
        fx.build_synthetic_state, fx.uncached_state_root = build, uncached
    types, final = seen["types"], seen["final"]
    routes, cons = report["tree_hash_routes"], report["conservation"]
    # the validators' roots (memoized by the path), and the host hashlib
    # ladder over them: the reference's "host" route at the same width
    vt = next(f.type.element for f in types.BeaconState.fields if f.name == "validators")
    vroots = np.stack([np.frombuffer(vt.hash_tree_root(v), np.uint8) for v in final.validators])
    router.set_hash_backend("host")
    t = time.perf_counter()
    host_root = tc._build(vroots, STATE_ROOT_N.bit_length() - 1)[1]
    host_ladder_s = time.perf_counter() - t
    router.set_hash_backend("device")
    checks = {"roots_distinct": cons["roots_distinct"],
              "root_matches_uncached": cons["root_matches_uncached"],
              "balances_conserved": cons["balances_ok"],
              "all_slots_rerooted": report["roots"] == sc.slots + 1,
              "device_ok_routes": routes.get("device/ok", 0) > 0,
              "no_device_error": not routes.get("host/device_error")}
    emit({"phase": "state_root", "scenario": sc.name, "validators": sc.n_validators,
          "slots": sc.slots, "churn": [sc.churn_validators, sc.churn_balances],
          "build_seconds": seen["build_s"], "cold_root_seconds": report["cold_ms"] / 1e3,
          "reroot_median_seconds": report["reroot_p50_ms"] / 1e3, "path_seconds": path_s,
          "uncached_root_seconds": seen["uncached_s"], "host_ladder_seconds_2_20": host_ladder_s,
          "root": seen["truth"].hex(), "routes": routes, "checks": checks,
          "report": {k: report[k] for k in ("hash_backend", "published", "mutations", "roots",
                                            "cold_ms", "reroot_p50_ms", "roots_per_sec",
                                            "conservation", "cow", "elapsed_secs")},
          "launches": launches_of(launches, "state_root")})
    if not all(checks.values()):
        raise SystemExit(f"the state_root path failed its checks: {checks}")
    return vroots, host_root


def epoch_phase(drive, launches, dev) -> tuple:
    """The epoch path: process_epoch on a seeded 2^20-validator state at
    slot 3 * SLOTS_PER_EPOCH - 1 on the "device" hash backend, driven with
    the launch counts reset, against the pure-Python loops on a deep copy
    ("host" backend): balances and effective balances equal, the
    epoch_deltas leg counted ok and never error. Returns the arguments the
    path gave epoch_deltas, on `dev`."""
    import copy

    from lighthouse_tpu_torch.state_transition import epoch as ep
    from lighthouse_tpu_torch.testing import state_fixtures as fx
    from lighthouse_tpu_torch.torchhash import epoch_vectors as ev
    from lighthouse_tpu_torch.torchhash import router

    t0 = time.perf_counter()
    spec, types, state = fx.build_synthetic_state(
        EPOCH_N, participation_seed=EPOCH_SEED, cache=False)
    state.slot = 3 * spec.preset.SLOTS_PER_EPOCH - 1
    fork = spec.fork_name_at_slot(state.slot)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = copy.deepcopy(state)
    copy_s = time.perf_counter() - t0
    captured, device_leg = [], ev._device_altair_deltas

    def capture(*args):             # keeps the device leg's arrays and scalars
        captured.append(args)
        return device_leg(*args)

    before = ev.epoch_totals()
    router.set_hash_backend("device")
    ev._device_altair_deltas = capture
    try:
        _, device_s = drive("epoch", EPOCH_PATH, lambda: ep.process_epoch(state, spec, types, fork))
    finally:
        ev._device_altair_deltas = device_leg
    totals = {k: v - before.get(k, 0) for k, v in ev.epoch_totals().items()}
    router.set_hash_backend("host")
    t0 = time.perf_counter()
    ep.process_epoch(host, spec, types, fork)
    host_s = time.perf_counter() - t0
    router.set_hash_backend("device")
    checks = {"balances_equal": list(state.balances) == list(host.balances),
              "effective_balances_equal": [v.effective_balance for v in state.validators]
              == [v.effective_balance for v in host.validators],
              "device_ok": totals.get("ok", 0) == 1 and len(captured) == 1,
              "no_device_error": not totals.get("error")}
    emit({"phase": "epoch", "validators": EPOCH_N, "slot": int(host.slot), "fork": fork.value,
          "build_seconds": build_s, "deepcopy_seconds": copy_s,
          "device_process_epoch_seconds": device_s, "host_process_epoch_seconds": host_s,
          "epoch_device_totals": totals, "checks": checks,
          "launches": launches_of(launches, "epoch")})
    if not all(checks.values()):
        raise SystemExit(f"the epoch path failed its checks: {checks}")
    _n, eff, part_masks, eligible, target, scores, *scalars = captured[0]
    return ev.kernel_inputs(dev, eff, part_masks, eligible, target, scores) + tuple(scalars)


def launches_of(launches, path: str) -> dict:
    """The tree-hash and epoch kernels' launch counts on `path`."""
    from lighthouse_tpu_torch.torchhash import kernels as HK

    return {k: v for k, v in launches[path].items() if k in HK.KERNELS}


def hash_kernel_row(name: str, case: str, args, int_ops: int, bytes_moved: int, reps: int,
                    plain_check=None) -> dict:
    """One torchhash kernel on args against its plain version on the card
    (torch.equal), with its CUDA-event ms, the plain version's ms and its
    bound from int_ops and bytes_moved."""
    wrapper, plain, _source, _replaces = kernel_registry()[name]
    kout, _ = sync_timed(wrapper, *args)
    pout, plain_ms = sync_timed(plain, *args)
    equal, err = compare(kout, pout)
    if plain_check is not None:
        equal = equal and plain_check(kout)
    ms = cuda_ms(lambda: wrapper(*args), reps)
    bms, by = bound_ms(0, bytes_moved, int_ops)
    row = {"name": name, "case": case, "equal": equal, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "int_ops": int_ops,
           "bytes": bytes_moved}
    emit({"phase": "hash_kernel", **row})
    if not equal:
        raise SystemExit(f"{name} disagrees with its plain version on {case}")
    return row


def hash_phase(drive, launches, dev) -> tuple[dict, dict]:
    """The state_root and epoch paths, then sha256_ladder, sha256_msgs and
    epoch_deltas against their plain versions on the card. Returns each
    kernel's row (the path's shape) and its arguments for the profiler."""
    import hashlib

    import numpy as np
    import torch

    from lighthouse_tpu_torch.ssz.core import ZERO_HASHES
    from lighthouse_tpu_torch.torchhash import engine
    from lighthouse_tpu_torch.torchhash import kernels as HK

    t0 = time.perf_counter()
    vroots, host_root = state_root_phase(drive, launches)
    state_root_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    epoch_args = epoch_phase(drive, launches, dev)
    epoch_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    gen = np.random.default_rng(0x5A256)

    def words(leaves):
        return torch.from_numpy(engine.words_from_leaves(leaves)).to(dev)

    def ladder_cost(n):
        nodes = sum(HK.ladder_widths(n))
        return nodes * SHA_NODE_OPS, 32 * (n + nodes)

    def zero_levels(levels):
        want = [torch.from_numpy(engine.words_from_leaves(
            np.frombuffer(z, np.uint8).reshape(1, 32))).to(dev) for z in ZERO_HASHES[1:]]
        return all(bool((lvl == want[d]).all()) for d, lvl in enumerate(levels))

    rows, args_of = {}, {}
    vwords = words(vroots)
    ops, moved = ladder_cost(STATE_ROOT_N)
    rows["sha256_ladder"] = hash_kernel_row(
        "sha256_ladder", "validator_roots_2_20", (vwords,), ops, moved, 20,
        lambda out: engine.leaves_from_words(out[-1].cpu().numpy())[0].tobytes() == host_root)
    args_of["sha256_ladder"] = (vwords,)
    cases = [("random_2_20", gen.integers(0, 256, (STATE_ROOT_N, 32), dtype=np.uint8))]
    cases += [(f"width_{n}", gen.integers(0, 256, (n, 32), dtype=np.uint8)) for n in LADDER_WIDTHS]
    for case, leaves in cases:
        ops, moved = ladder_cost(leaves.shape[0])
        hash_kernel_row("sha256_ladder", case, (words(leaves),), ops, moved, 5)
    ops, moved = ladder_cost(STATE_ROOT_N)
    hash_kernel_row("sha256_ladder", "zero_2_20", (words(np.zeros((STATE_ROOT_N, 32), np.uint8)),),
                    ops, moved, 5, zero_levels)

    # sha256_msgs at the padding edges, against hashlib too
    for length in MSG_LENGTHS:
        msgs = gen.integers(0, 256, (MSG_N, length), dtype=np.uint8)
        mw = torch.from_numpy(engine.msg_words(msgs)).to(dev)
        blocks = mw.shape[1] // 16

        def hashlib_equal(out, msgs=msgs):
            got = engine.leaves_from_words(out.cpu().numpy())
            return all(got[i].tobytes() == hashlib.sha256(msgs[i].tobytes()).digest()
                       for i in range(MSG_N))

        row = hash_kernel_row("sha256_msgs", f"length_{length}", (mw,),
                              MSG_N * blocks * SHA_BLOCK_OPS, MSG_N * (length + 32), 20,
                              hashlib_equal)
        if length == max(MSG_LENGTHS):
            rows["sha256_msgs"], args_of["sha256_msgs"] = row, (mw,)

    # epoch_deltas on the path's inputs, steady and in a leak, and on
    # numerators in [2^63, 2^64): 32 ETH balances, scores near 2^64 / 32 ETH
    n = int(epoch_args[0].shape[0])
    epoch_moved = n * (8 + 8 + 7 * 8) + (5 * n + 7) // 8
    rows["epoch_deltas"] = hash_kernel_row("epoch_deltas", "epoch_path_steady", epoch_args,
                                           n * EPOCH_OPS, epoch_moved, 20)
    args_of["epoch_deltas"] = epoch_args
    hash_kernel_row("epoch_deltas", "epoch_path_leak", epoch_args[:-1] + (True,),
                    n * EPOCH_OPS, epoch_moved, 5)
    scores = torch.from_numpy(gen.integers(400_000_000, 500_000_000, n, dtype=np.int64)).to(dev)
    eff = torch.full((n,), 32 * 10**9, dtype=torch.int64, device=dev)
    edge = (eff,) + tuple(epoch_args[1:4]) + (scores,) + tuple(epoch_args[5:])
    wide = int(((eff * scores) < 0).sum())                 # products at or above 2^63
    hash_kernel_row("epoch_deltas", "near_2_64", edge, n * EPOCH_OPS, epoch_moved, 5,
                    lambda out: wide > n // 2)
    emit({"phase": "hash_paths_seconds", "state_root": state_root_s, "epoch": epoch_s,
          "kernel_checks": time.perf_counter() - t0, "near_2_64_products": wide})
    return rows, args_of


# ------------------------------------------------------------ hybrid router


def hybrid_routes() -> dict:
    """bls_hybrid_route_total by "path/reason"."""
    from lighthouse_tpu_torch.crypto.bls import hybrid

    return {f"{p}/{r}": c.value for (p, r), c in hybrid._ROUTE_DECISIONS.children()}


def hybrid_phase(launches, smi, att, tampered, single, rands, agg) -> None:
    """The hybrid router on the card (bls.set_backend("hybrid")), its launch
    counts reset at its start and read before the ledger step: the probe
    waited for and "up"; the urgent (4, 1) verify first to host/device_cold,
    then, after its warm, to device/ok, a tampered one false; three gossip
    (64, 128) verifies through the router alternated with three straight
    through the "torch" backend (the medians' difference is the router's
    overhead), the tampered batch false; 8 async submissions with the 5th
    tampered; AggregateVerify; the KZG fixture's 6 commitments through the
    router's g1_msm_fixed. Every verify after the urgent warm-up routes to
    device/ok; no host/device_error, host/device_down or host/circuit_open;
    the breaker closed; every BLS path kernel, fq_mont_mul and msm_fixed
    launched. Then the device ledger, reset at the phase's start: a
    state root and process_epoch at HYBRID_STATE_N validators book the
    tree_hash and epoch tenants; bls, tree_hash and epoch each closed an
    interval, and busy + contended + idle equals the ledger's window."""
    import statistics
    import threading

    from lighthouse_tpu_torch.autotune import profile as at_profile
    from lighthouse_tpu_torch.crypto import bls, kzg
    from lighthouse_tpu_torch.crypto.bls import hybrid
    from lighthouse_tpu_torch.crypto.bls381 import serde
    from lighthouse_tpu_torch.observability.device_ledger import LEDGER
    from lighthouse_tpu_torch.state_transition import epoch as ep
    from lighthouse_tpu_torch.testing import state_fixtures as fx
    from lighthouse_tpu_torch.utils import fixtures

    LEDGER.reset()
    reset_launches()
    routes0 = hybrid_routes()

    def routes_since(before) -> dict:
        return {k: v - before.get(k, 0) for k, v in hybrid_routes().items()
                if v != before.get(k, 0)}

    def timed(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t

    # 1. the probe, waited for
    router = bls.set_backend("hybrid")
    t0 = time.perf_counter()
    router._ensure_probe()
    router._probe_done.wait(PROBE_WAIT_S)
    probe_s = time.perf_counter() - t0
    key = at_profile.current_device_key()
    emit({"phase": "hybrid_probe", "device": smi, "state": router._state,
          "probe_seconds": probe_s, "device_key": key})
    if router._state != "up":
        raise SystemExit(f"the hybrid router's probe ended {router._state!r}, want 'up'")

    # 2. urgent (4, 1): host while cold, a warm in the background, then the card
    s0 = single
    bad_single = [bls.SignatureSet(s0.signature, s0.signing_keys, bytes([s0.message[0] ^ 1]) + s0.message[1:])]
    bucket = router._bucket([s0])
    warm_at = []

    def watch_warm():                       # the warm runs beside the host verify
        while bucket not in router._warm_buckets and time.perf_counter() - t0 < PROBE_WAIT_S:
            time.sleep(0.001)
        warm_at.append(time.perf_counter())

    before = hybrid_routes()
    t0 = time.perf_counter()
    watcher = threading.Thread(target=watch_warm)
    watcher.start()
    cold_ok, cold_s = timed(bls.verify_signature_sets, [s0], rands)
    watcher.join()
    warm_s = warm_at[0] - t0
    cold_routes = routes_since(before)
    before = hybrid_routes()
    urgent_ok, urgent_s = timed(bls.verify_signature_sets, [s0], rands)
    urgent_bad = bls.verify_signature_sets(bad_single, rands)
    urgent_routes = routes_since(before)

    # 3. gossip (64, 128): hybrid and straight "torch", alternated
    hybrid_s, direct_s, gossip_ok = [], [], []
    for _ in range(VERIFY_REPEATS):
        bls.set_backend("hybrid")
        ok, dt = timed(bls.verify_signature_sets, att, rands)
        gossip_ok.append(ok)
        hybrid_s.append(dt)
        bls.set_backend("torch")
        ok, dt = timed(bls.verify_signature_sets, att, rands)
        gossip_ok.append(ok)
        direct_s.append(dt)
    bls.set_backend("hybrid")
    gossip_bad = bls.verify_signature_sets(tampered, rands)

    # 4. pipelined: 8 async submissions, the 5th tampered
    batches = [tampered if i == 4 else att for i in range(PIPELINED)]
    handles, pipelined_s = timed(lambda: [bls.verify_signature_sets_async(b, rands) for b in batches])
    verdicts = [h.result() for h in handles]

    # 5. AggregateVerify of the 64 distinct messages
    agg_pks, msgs, agg_sig = agg
    agg_ok, agg_s = timed(bls.aggregate_verify, agg_pks, msgs, agg_sig)

    # 6. the KZG fixture's commitments through the router's g1_msm_fixed
    kz = fixtures.load_kzg(FIXTURES)
    setup = kzg.TrustedSetup(kz["g1_lagrange"], kz["g2_monomial"],
                             kzg._fr_roots_of_unity(len(kz["g1_lagrange"])))
    commits, commit_s = timed(lambda: [kzg.blob_to_kzg_commitment(b, setup) for b in kz["blobs"]])
    commits_equal = [c == serde.g1_decompress(cb) for c, cb in zip(commits, kz["commitments"])]

    # 7. routes and launches
    launches["hybrid"] = {name: k[0].launches for name, k in kernel_registry().items()}
    routes = routes_since(routes0)
    required = set(MAIN_PATH) | set(HYBRID_EXTRA)
    n_device = 2 + VERIFY_REPEATS + 1 + PIPELINED + 1    # urgent, gossip, tampered, async, aggregate
    checks = {
        "probe_up": router._state == "up",
        "urgent_cold_to_host": cold_ok is True and cold_routes == {"host/device_cold": 1},
        "urgent_warm_to_device": urgent_ok is True and urgent_bad is False
        and urgent_routes == {"device/ok": 2},
        "gossip": gossip_ok == [True] * (2 * VERIFY_REPEATS) and gossip_bad is False,
        "pipelined": verdicts == [i != 4 for i in range(PIPELINED)],
        "aggregate_verify": agg_ok is True,
        "kzg_commitments_equal": all(commits_equal) and len(commits_equal) == KZG_BLOBS,
        "routes": routes == {"host/device_cold": 1, "device/ok": n_device},
        "circuit_closed": hybrid._CIRCUIT_STATE.value == 0 and router._breaker.state() == "closed",
        "kernels_launched": all(launches["hybrid"][k] > 0 for k in required),
    }
    emit({"phase": "hybrid", "device": smi, "probe_seconds": probe_s,
          "urgent": {"bucket": list(bucket[1]), "lane": bucket[0], "cold_host_seconds": cold_s,
                     "first_dispatch_seconds": warm_s, "warm": bucket in router._warm_buckets,
                     "device_seconds": urgent_s},
          "gossip": {"bucket": [len(att), N_PKS], "hybrid_seconds": hybrid_s,
                     "direct_seconds": direct_s, "hybrid_median_seconds": statistics.median(hybrid_s),
                     "direct_median_seconds": statistics.median(direct_s),
                     "first_dispatch_seconds": hybrid_s[0]},
          "pipelined": {"verdicts": verdicts, "submit_seconds": pipelined_s},
          "aggregate_verify_seconds": agg_s, "kzg_commitments_seconds": commit_s,
          "routes": routes, "launches": launches["hybrid"], "checks": checks})
    if not all(checks.values()):
        raise SystemExit(f"the hybrid phase failed its checks: {checks}")

    # 8. the device ledger: tree_hash and epoch intervals, then conservation
    spec, types, state = fx.build_synthetic_state(HYBRID_STATE_N, participation_seed=EPOCH_SEED, cache=False)
    types.BeaconState.hash_tree_root(state)
    state.slot = 3 * spec.preset.SLOTS_PER_EPOCH - 1
    ep.process_epoch(state, spec, types, spec.fork_name_at_slot(state.slot))
    bls.set_backend("torch")
    snap = LEDGER.snapshot()
    closed, busy = {}, {}
    for track, _name, t0, t1, _args in LEDGER.perfetto_device_timeline():
        if not track.endswith(":wait"):
            closed[track] = closed.get(track, 0) + 1
            busy[track] = busy.get(track, 0.0) + (t1 - t0)
    cons = snap["conservation"]
    chip = cons["per_chip"][0]
    total = chip["busy"] + chip["contention_wait"] + chip["idle"]
    ledger_checks = {
        "bls_tree_hash_epoch_closed": all(closed.get(w, 0) > 0 for w in ("bls", "tree_hash", "epoch")),
        "conservation": len(cons["per_chip"]) == 1 and abs(total - cons["wall"]) <= 1e-6 * cons["wall"],
        "no_open_intervals": not snap["open_intervals"],
    }
    emit({"phase": "hybrid_ledger", "device": smi, "validators": HYBRID_STATE_N,
          "closed_intervals": closed, "busy_seconds": busy, "contention": snap["contention"],
          "registry": snap["registry"], "conservation": cons, "checks": ledger_checks})
    if not all(ledger_checks.values()):
        raise SystemExit(f"the device ledger failed its checks: {ledger_checks}")


def calibrate_phase(launches, smi, att, rands, check_kernels) -> tuple[dict, dict]:
    """The autotune calibrator through the port's CLI on the card:
    `python -m lighthouse_tpu_torch autotune calibrate --out <tmp>` as
    cli.main, at its default reps on the full bench_fixtures.npz, with the
    autotune profiler and the launch counts reset just before it. Checks:
    exit 0; the profile's key (platform gpu, this card's name, revision
    t1); exactly the sweep's buckets, each with CALIBRATE_REPS + 1 samples
    (the attribution pass is each bucket's first dispatch: no verify counted
    twice) and the four stages' programs; the host reference; the MSM
    width, every width's sum equal to the pure-Python sum (the "python"
    backend's, kzg._g1_lincomb's host lane) of the sweep's 32 points and
    scalars; the ladder's bucket and root (hashlib's over the same zero
    leaves); the plan installs, msm_window() gives its width and
    start_warmup() warms its ladders; every kernel of CALIBRATE_PATH
    launched; the 512 fixture sets, the widest bucket, rejected with one
    message byte flipped; then the six path kernels against their plain
    versions at (4, 128), the calibration's own workload there. Then
    runtime.clear() and the earlier BLS backend back. Returns the kernel
    rows and the arguments of that check."""
    import random
    import tempfile

    import torch

    from lighthouse_tpu_torch import cli
    from lighthouse_tpu_torch.autotune import calibrate, profile, profiler, runtime
    from lighthouse_tpu_torch.crypto import bls, kzg
    from lighthouse_tpu_torch.crypto.torchbls import msm
    from lighthouse_tpu_torch.ssz.core import ZERO_HASHES
    from lighthouse_tpu_torch.torchhash import engine, router
    from lighthouse_tpu_torch.utils import fixtures

    previous = bls.get_backend().name
    profiler.reset()
    torch.cuda.synchronize()
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "profile.json")
        t0 = time.perf_counter()
        rc = cli.main(["autotune", "calibrate", "--out", out, "--fixtures", FIXTURES])
        seconds = time.perf_counter() - t0
        launches["calibrate"] = {name: k[0].launches for name, k in kernel_registry().items()}
        prof = profile.load(out)
    sweep = calibrate.last_run.get("msm_sweep", {})

    # the widest bucket, (512, 128), new to the card: a flipped byte fails
    wide = fixtures.load_groups(FIXTURES)["att"]
    s7 = wide[7]
    wide[7] = bls.SignatureSet(s7.signature, s7.signing_keys, bytes([s7.message[0] ^ 1]) + s7.message[1:])
    t1 = time.perf_counter()
    wide_tampered = bls.verify_signature_sets(wide, rands)
    wide_s = time.perf_counter() - t1

    # the sweep's MSM on the host: its 32 points and scalars
    pts = fixtures.load_kzg(FIXTURES)["g1_lagrange"][:calibrate.MSM_SWEEP_POINTS]
    rng = random.Random(0xA08)
    scalars = [rng.getrandbits(255) for _ in pts]
    bls.set_backend("python")
    t1 = time.perf_counter()
    host_sum = kzg._g1_lincomb(pts, scalars)
    host_msm_s = time.perf_counter() - t1

    # the plan: installed, read by msm_window() and the ladder's warm-up
    warmed, real_warm = [], engine.warm_tree_bucket
    engine.warm_tree_bucket = lambda n: warmed.append(n) or real_warm(n)
    try:
        plan = runtime.install_profile(prof)
        plan_window = msm.msm_window()
        router.start_warmup().join(PROBE_WAIT_S)
    finally:
        engine.warm_tree_bucket = real_warm
        runtime.clear()
        bls.set_backend(previous)
    reps = CALIBRATE_REPS
    buckets = sorted(prof.buckets)
    checks = {
        "exit_0": rc == 0,
        "key": prof.key.get("platform") == "gpu"
        and prof.key.get("device_kind") == torch.cuda.get_device_name(0)
        and prof.key.get("backend_revision") == profile.BACKEND_REVISION == "t1",
        "buckets": buckets == sorted(CALIBRATE_BUCKETS),
        "samples": all(b.samples == reps + 1 for b in prof.buckets.values()),
        "programs": all(sorted(b.programs or {}) == ["h2c", "pairing", "pairs", "prepare"]
                        for b in prof.buckets.values()),
        "host": (prof.host or {}).get("single_set_ms", 0) > 0,
        "msm_window": prof.msm_window in (0, 2, 4, 5, 6),
        "msm_sums": bool(sweep) and sweep["sum"] == host_sum and host_sum is not None,
        "tree_hash": prof.tree_hash_buckets == (16384,)
        and calibrate.last_run.get("tree_hash_roots", {}).get(16384) == ZERO_HASHES[14].hex(),
        "plan": plan is not None and plan_window == prof.msm_window
        and warmed == [16384] == list(plan.tree_hash_warmup),
        "kernels_launched": all(launches["calibrate"][k] > 0 for k in CALIBRATE_PATH),
        "wide_tampered_rejected": wide_tampered is False and len(wide) == 512,
    }
    emit({"phase": "calibrate", "device": smi, "seconds": seconds, "exit_code": rc,
          "key": prof.key, "reps": reps,
          "buckets": {f"{n}x{m}": {"samples": b.samples, "compile_secs": b.compile_secs,
                                   "p50_ms": b.p50_ms, "p99_ms": b.p99_ms,
                                   "sets_per_sec": b.sets_per_sec,
                                   "programs": b.programs}
                      for (n, m), b in sorted(prof.buckets.items())},
          "host": prof.host, "msm_window": prof.msm_window,
          "msm_secs_by_window": sweep.get("secs_by_window"), "host_msm_seconds": host_msm_s,
          "tree_hash_buckets": prof.tree_hash_buckets, "wide_tampered_seconds": wide_s, "plan": {
              "max_attestation_batch": plan.max_attestation_batch if plan else None,
              "p99_budget_ms": plan.p99_budget_ms if plan else None,
              "urgent_max_sets": plan.urgent_max_sets if plan else None,
              "warmup_buckets": list(plan.warmup_buckets) if plan else None,
              "msm_window": plan.msm_window if plan else None},
          "launches": launches["calibrate"], "checks": checks})
    if not all(checks.values()):
        raise SystemExit(f"the calibrate phase failed its checks: {checks}")
    rows, _own, args = check_kernels("calibrate", att[:1])
    return rows, args


def stage_series() -> dict:
    """torchbls_stage_device_seconds by (stage, n_sets, n_pks): (count,
    total seconds)."""
    from lighthouse_tpu_torch.observability import device as obsdev

    return {key: (c.n, c.total) for key, c in obsdev.STAGE_DEVICE_SECONDS.children()}


def attribution_phase(smi, att, rands) -> dict:
    """Per-stage device attribution on the card: profile_stages at the
    gossip bucket (3 reps on random interchange limbs), then one gossip
    verify through bls.verify_signature_sets under device.attributed();
    each stage's CUDA-event ms and its share of its bound (perf.roofline on
    the work counted on that run's own inputs). Fails if a share exceeds 1
    (a miscount) or the verify fails. Returns the verify's event ms per
    stage."""
    import torch

    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.observability import device as obsdev
    from lighthouse_tpu_torch.observability import perf

    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    # each run's shares against the work of its own inputs: the programs
    # the calibrator counted at this bucket had coefficients z = 1
    perf.reset_programs()
    standalone = obsdev.profile_stages(N_SETS, N_PKS, reps=3)
    before = stage_series()
    perf.reset_programs()
    prev = perf.set_analytics(True)
    try:
        with obsdev.attributed():
            ok = bls.verify_signature_sets(att, rands)
    finally:
        perf.set_analytics(prev)
    after = stage_series()
    seconds = time.perf_counter() - t0
    verify = {}
    for stage in obsdev.STAGES:
        key = (stage, str(N_SETS), str(N_PKS))
        n0, s0 = before.get(key, (0, 0.0))
        n1, s1 = after.get(key, (0, 0.0))
        secs = (s1 - s0) / (n1 - n0) if n1 > n0 else None
        rl = perf.roofline(perf.program_stats(stage, (N_SETS, N_PKS)) or {}, secs, kind)
        verify[stage] = {"event_ms": secs * 1e3 if secs else None,
                         "bound_ms": (rl or {}).get("bound_ms"),
                         "bound_share": (rl or {}).get("bound_share")}
    shares = [v["bound_share"] for v in verify.values()]
    shares += [s.get("roofline", {}).get("bound_share") for s in standalone["stages"].values()]
    checks = {
        "verified": ok is True,
        "every_stage_timed": all(v["event_ms"] for v in verify.values())
        and sorted(standalone["stages"]) == sorted(obsdev.STAGES),
        "shares_at_most_1": all(s is not None and 0 < s <= 1.0 for s in shares),
    }
    emit({"phase": "attribution", "device": smi, "bucket": [N_SETS, N_PKS],
          "seconds": seconds, "profile_stages": standalone, "gossip_verify": verify,
          "checks": checks})
    if not all(checks.values()):
        raise SystemExit(f"the attribution phase failed its checks: {checks}")
    return verify


# ------------------------------------------------------------ phases


# ------------------------------------------------------------ block import


CHILDREN = []                     # processes the script started; main() stops them


def start_block_fixture():
    """Build (or load) testing/block_fixtures.py's mainnet block in a
    process of its own, on the host ("host" hash backend, no card), while
    the card runs the phases before block_mainnet."""
    env = dict(os.environ, LIGHTHOUSE_TPU_HASH_BACKEND="host", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen([sys.executable, "-m", "lighthouse_tpu_torch.testing.block_fixtures"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    CHILDREN.append(proc)
    return proc


class CallTimer:
    """Wall seconds spent in chosen functions while installed: each
    (owner, attribute, label) is wrapped, and a label's calls are summed."""

    def __init__(self, targets):
        self.targets, self.seconds, self.saved = targets, {}, []

    def __enter__(self):
        for owner, attr, label in self.targets:
            fn = getattr(owner, attr)
            self.saved.append((owner, attr, fn))

            def timed(*args, _fn=fn, _label=label, **kwargs):
                t = time.perf_counter()
                try:
                    return _fn(*args, **kwargs)
                finally:
                    self.seconds[_label] = self.seconds.get(_label, 0.0) + time.perf_counter() - t

            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self.saved):
            setattr(owner, attr, fn)
        self.saved = []


def ef_state_phase(launches) -> None:
    """Every state-transition case under tests/ef/vectors/minimal (all but
    ssz_static) through the port's ef_runner on "torch" with the vectors'
    real signatures, in EF_STATE_WORKERS processes: each case must pass."""
    from lighthouse_tpu_torch.testing import ef_runner

    out = ef_runner.run_vectors(
        EF_STATE_ROOT, select=lambda c, f, r, h, d: c == "minimal" and r != "ssz_static",
        backend="torch", workers=EF_STATE_WORKERS)
    launches["ef_state"] = {name: out["launches"].get(name, 0) for name in kernel_registry()}
    by_runner = {}
    for case, seconds in out["seconds"].items():
        runner = case.split("/")[2]
        by_runner[runner] = by_runner.get(runner, 0.0) + seconds
    cases = sum(out["passed"].values()) + len(out["failed"])
    emit({"phase": "ef_state", "backend": "torch", "workers": EF_STATE_WORKERS, "cases": cases,
          "passed_by_runner": out["passed"], "failed": out["failed"][:10],
          "wall_seconds": out["wall_seconds"], "case_seconds_by_runner": by_runner,
          "slowest": sorted(out["seconds"].items(), key=lambda kv: -kv[1])[:5],
          "launches": {k: v for k, v in launches["ef_state"].items() if v}})
    if out["failed"] or cases != EF_STATE_CASES:
        raise SystemExit(f"EF state vectors failed: {len(out['failed'])} of {cases}")
    missing = [k for k in MAIN_PATH if not launches["ef_state"][k]]
    if missing:
        raise SystemExit(f"kernels not launched on the ef_state path: {missing}")


def block_path_hash_rows(path: str, captured) -> tuple[dict, dict]:
    """sha256_ladder at each width the block path's device tree builds
    hashed (`captured["leaves"]`, the widest first) and epoch_deltas on the
    epoch leg's inputs (`captured["epoch"]`, where the path ran it), against
    their plain versions on the card. Returns the rows (the widest ladder)
    and their arguments."""
    import numpy as np
    import torch

    from lighthouse_tpu_torch.torchhash import engine
    from lighthouse_tpu_torch.torchhash import epoch_vectors as ev
    from lighthouse_tpu_torch.torchhash import kernels as HK

    hash_rows, hash_args, by_width = {}, {}, {}
    for leaves, *_depth in captured["leaves"]:    # the ladder's input, as the engine places it
        words = np.zeros((engine.hash_bucket(leaves.shape[0]), 8), np.int32)
        words[:leaves.shape[0]] = engine.words_from_leaves(leaves)
        by_width.setdefault(words.shape[0], (torch.from_numpy(words).to(engine.device()),))
    for n, a in sorted(by_width.items(), reverse=True):       # each width the path hashed
        nodes = sum(HK.ladder_widths(n))
        row = hash_kernel_row("sha256_ladder", f"{path}_{n}", a, nodes * SHA_NODE_OPS,
                              32 * (n + nodes), 5)
        hash_rows.setdefault("sha256_ladder", row)
        hash_args.setdefault("sha256_ladder", a)
    if not captured["epoch"]:                 # a path that crossed no epoch boundary
        return hash_rows, hash_args
    _n, eff, part_masks, eligible, target, scores, *scalars = captured["epoch"][0]
    e = ev.kernel_inputs(engine.device(), eff, part_masks, eligible, target, scores) + tuple(
        scalars)
    n = int(e[0].shape[0])
    hash_rows["epoch_deltas"] = hash_kernel_row(
        "epoch_deltas", path, e, n * EPOCH_OPS, n * (8 + 8 + 7 * 8) + (5 * n + 7) // 8, 5)
    hash_args["epoch_deltas"] = e
    return hash_rows, hash_args


def block_mainnet_phase(drive, launches, check_kernels, smi, fixture_proc):
    """The mainnet block's import through slot.state_transition (VERIFY_BULK,
    "torch", the "device" hash backend), driven with the launch counts
    reset, its wall time split by CallTimer; then the same block under
    NO_VERIFICATION (the same root) and with two attestations' signatures
    swapped (rejected), and each kernel of the path against its plain
    version at the path's shapes. Returns the path kernels' rows, the
    hash kernels' rows and their arguments, the import to profile, the
    fixture and the post-state root."""
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.torchbls import backend as be
    from lighthouse_tpu_torch.state_transition import block as blk
    from lighthouse_tpu_torch.state_transition import signature_sets as sigs
    from lighthouse_tpu_torch.state_transition import slot as sl
    from lighthouse_tpu_torch.testing import block_fixtures as bf
    from lighthouse_tpu_torch.torchhash import engine
    from lighthouse_tpu_torch.torchhash import epoch_vectors as ev
    from lighthouse_tpu_torch.torchhash import router
    from lighthouse_tpu_torch.types.state_util import clone_state

    t0 = time.perf_counter()
    out, err = fixture_proc.communicate(timeout=FIXTURE_WAIT_S)
    if fixture_proc.returncode != 0:
        raise SystemExit(f"the block fixture's build failed: {err[-3000:]}")
    built = json.loads(out.strip().splitlines()[-1])
    wait_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fx = bf.load_or_build()
    load_s = time.perf_counter() - t0
    spec, types, pre, signed = fx.spec, fx.types, fx.pre_state, fx.block
    router.set_hash_backend("device")
    bls.set_backend("torch")
    backend = bls.get_backend()
    t0 = time.perf_counter()
    types.BeaconState.hash_tree_root(pre)          # a node's head state: its tree caches warm
    warm_s = time.perf_counter() - t0

    # the batch's sets, the leaves of each device tree build and the epoch
    # leg's arrays (the kernel wrappers count launches on their own names,
    # so their callers are wrapped, not they)
    captured = {"sets": [], "leaves": [], "epoch": []}

    def capture(label, fn):
        def wrapped(*args, **kwargs):
            captured[label].append(list(args[0].sets) if label == "sets" else args)
            return fn(*args, **kwargs)
        return wrapped

    set_builders = ("block_proposal_set", "randao_set", "indexed_attestation_set",
                    "sync_aggregate_set")
    timer = CallTimer([(sl, "process_slots", "process_slots"), (sl, "process_epoch", "epoch"),
                       (sl, "per_block_processing", "per_block_processing"),
                       (blk.SignatureBatch, "verify", "batch_verify"),
                       (backend, "marshal", "marshal")]
                      + [(sigs, name, "build_sets") for name in set_builders])
    saved = (blk.SignatureBatch.verify, engine.device_build_levels, ev._device_altair_deltas)
    blk.SignatureBatch.verify = capture("sets", saved[0])
    engine.device_build_levels = capture("leaves", saved[1])
    ev._device_altair_deltas = capture("epoch", saved[2])
    routes_before, epoch_before = router.route_totals(), ev.epoch_totals()
    state = clone_state(pre, spec)
    try:
        with timer:
            post, wall_s = drive("block_mainnet", BLOCK_PATH, lambda: sl.state_transition(
                state, signed, spec, strategy=blk.SignatureStrategy.VERIFY_BULK))
    finally:
        blk.SignatureBatch.verify, engine.device_build_levels, ev._device_altair_deltas = saved
    routes = {k: v - routes_before.get(k, 0) for k, v in router.route_totals().items()
              if v != routes_before.get(k, 0)}
    epochs = {k: v - epoch_before.get(k, 0) for k, v in ev.epoch_totals().items()}
    post_root = types.BeaconState.hash_tree_root(post)
    T = timer.seconds
    split = {"process_slots": T["process_slots"], "epoch": T["epoch"],
             "state_roots_in_process_slots": T["process_slots"] - T["epoch"],
             "build_sets": T["build_sets"], "batch_verify": T["batch_verify"],
             "marshal": T["marshal"], "dispatch_to_verdict": T["batch_verify"] - T["marshal"],
             "rest_of_per_block_processing":
                 T["per_block_processing"] - T["build_sets"] - T["batch_verify"],
             "post_state_root": wall_s - T["process_slots"] - T["per_block_processing"]}

    # the same block without verification, then the swapped one
    t0 = time.perf_counter()
    quiet = sl.state_transition(clone_state(pre, spec), signed, spec,
                                strategy=blk.SignatureStrategy.NO_VERIFICATION)
    quiet_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        sl.state_transition(clone_state(pre, spec), fx.swapped, spec,
                            strategy=blk.SignatureStrategy.VERIFY_BULK)
        swapped_rejected = False
    except blk.BlockProcessingError as e:
        swapped_rejected = "bulk signature" in str(e)
    swapped_s = time.perf_counter() - t0
    sets = captured["sets"][0] if len(captured["sets"]) == 1 else []
    bucket = be.padding_bucket(len(sets), max(len(x.signing_keys) for x in sets)) if sets else None
    checks = {"root_equals_block": post_root == bytes(signed.message.state_root),
              "root_equals_no_verification": types.BeaconState.hash_tree_root(quiet) == post_root,
              "swapped_rejected": swapped_rejected,
              "one_batch_of_131": len(captured["sets"]) == 1 and len(sets) == BLOCK_SETS,
              "bucket": bucket == BLOCK_BUCKET,
              "device_ok_routes": routes.get("device/ok", 0) > 0,
              "no_device_error": not routes.get("host/device_error"),
              "epoch_device_ok": epochs.get("ok", 0) >= 1 and not epochs.get("error")}
    emit({"phase": "block_mainnet", "nvidia_smi": smi, "validators": len(pre.validators),
          "slot": int(signed.message.slot), "sets": len(sets), "bucket": bucket,
          "attestations": len(signed.message.body.attestations),
          "fixture": {"build": built, "wait_seconds": wait_s, "load_seconds": load_s,
                      "warm_root_seconds": warm_s},
          "import_seconds": wall_s, "split_seconds": split,
          "no_verification_seconds": quiet_s, "swapped_seconds": swapped_s,
          "routes": routes, "epoch_device_totals": epochs, "checks": checks,
          "device_tree_builds": [int(a[0].shape[0]) for a in captured["leaves"]],
          "launches": launches["block_mainnet"]})
    if not all(checks.values()):
        raise SystemExit(f"the block_mainnet path failed its checks: {checks}")

    # each kernel of the path against its plain version at its shapes
    rows, own, args = check_kernels("block_mainnet", sets)
    hash_rows, hash_args = block_path_hash_rows("block_mainnet", captured)

    def profiled_import():
        """The import once more, its signatures cached (the first import
        timed their decompression)."""
        st = clone_state(pre, spec)
        return lambda: sl.state_transition(st, signed, spec,
                                           strategy=blk.SignatureStrategy.VERIFY_BULK)

    return rows, args, hash_rows, hash_args, profiled_import, fx, post_root


def beacon_chain_phase(drive, launches, check_kernels, smi, fx, post_root):
    """The mainnet block through chain/beacon_chain.py's BeaconChain on
    "torch" and the "device" hash backend: a chain anchored at the
    fixture's genesis state (the anchor root derived from its
    latest_block_header, the block's parent: the 63 slots before it are
    empty), its state-advance timer at slot 63 (advance_head_state: slots
    0 to 64, the epoch transitions), then per_slot_task at slot 64,
    verify_block_for_gossip and process_block with the proposal verified,
    driven with the launch counts reset and their walls split by
    CallTimer, the signatures cached as block_mainnet's import left them
    (their decompression is timed there). A chain anchored in a later
    epoch, at the pre-state of slot 63, takes that epoch as finalized
    (ForkChoice's anchor checkpoints) and never makes the block head: its
    post-state's finalized epoch is 0
    (the JAX package's chain does the same). Checks the head, its state
    root (the block's and block_mainnet's), the store's block and state
    and the fork-choice head. A fresh chain rejects the swapped copy and
    keeps its anchor. Then SINGLES unaggregated attestations of slot 64,
    signed on SIGN_WORKERS spawned processes, in one gossip batch
    (verify_unaggregated_attestations): all verified and applied to fork
    choice, then deduped; on a chain started from the imported block by
    from_checkpoint, the same with one signed by the wrong key: the batch
    fails and the per-set fallback keeps the other SINGLES - 1; on
    another, submit_attestation_batch through the dispatcher: the same
    verdicts. Last, each kernel of the path against its plain version at
    the import's and the singles' shapes. Returns the rows and arguments
    of both buckets, the hash kernels' rows, the import to profile, and
    what the beacon_processor phase reuses: the head state, the singles,
    the copy with the bad one and their validators."""
    import multiprocessing as mp

    from lighthouse_tpu_torch.chain import beacon_chain as bc
    from lighthouse_tpu_torch.chain.pubkey_cache import ValidatorPubkeyCache
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.torchbls import backend as be
    from lighthouse_tpu_torch.fork_choice.fork_choice import ForkChoice
    from lighthouse_tpu_torch.state_transition import accessors as acc
    from lighthouse_tpu_torch.state_transition import signature_sets as sigs
    from lighthouse_tpu_torch.state_transition import slot as sl
    from lighthouse_tpu_torch.store.hot_cold import HotColdDB
    from lighthouse_tpu_torch.testing import block_fixtures as bf
    from lighthouse_tpu_torch.torchhash import engine
    from lighthouse_tpu_torch.torchhash import epoch_vectors as ev
    from lighthouse_tpu_torch.torchhash import router
    from lighthouse_tpu_torch.types import helpers as h
    from lighthouse_tpu_torch.types.spec import DOMAIN_BEACON_ATTESTER
    from lighthouse_tpu_torch.types.state_util import clone_state

    spec, types, genesis, signed = fx.spec, fx.types, fx.genesis_state, fx.block
    router.set_hash_backend("device")
    bls.set_backend("torch")
    backend = bls.get_backend()
    slot = int(signed.message.slot)
    root = types.BeaconBlock.hash_tree_root(signed.message)

    def new_chain():
        t = time.perf_counter()
        chain = bc.BeaconChain(spec, clone_state(genesis, spec))
        return chain, time.perf_counter() - t

    def advance(chain):
        """The state-advance timer in the slot before the block's."""
        t = time.perf_counter()
        chain.slot_clock.set_slot(slot - 1)
        chain.per_slot_task()
        if not chain.advance_head_state():
            raise SystemExit("the chain's head state did not advance")
        return time.perf_counter() - t

    def checkpoint_chain(state):
        """A chain started from the imported block and its post-state."""
        t = time.perf_counter()
        chain = bc.BeaconChain.from_checkpoint(spec, clone_state(state, spec), signed)
        chain.slot_clock.set_slot(slot)
        chain.per_slot_task()
        return chain, time.perf_counter() - t

    chain, init_s = new_chain()
    if chain.genesis_block_root != bytes(signed.message.parent_root):
        raise SystemExit("the chain's anchor root is not the block's parent root")

    # every batch's sets, the device tree builds' leaves and the epoch leg's
    # arrays (their callers wrapped: the kernel wrappers count launches)
    captured = {"sets": [], "leaves": [], "epoch": []}

    def capture(label, fn):
        def wrapped(*args, **kwargs):
            captured[label].append(list(args[0]) if label == "sets" else args)
            return fn(*args, **kwargs)
        return wrapped

    def split_timer():
        builders = ("block_proposal_set", "randao_set", "indexed_attestation_set",
                    "sync_aggregate_set")
        return CallTimer([(bc.BeaconChain, "_state_for_block", "state_for_block"),
                          (bls, "verify_signature_sets", "batch_verify"),
                          (backend, "marshal", "marshal"),
                          (HotColdDB, "put_block", "store_writes"),
                          (HotColdDB, "put_state", "store_writes"),
                          (ForkChoice, "on_block", "fork_choice"),
                          (bc.BeaconChain, "recompute_head", "fork_choice"),
                          (ValidatorPubkeyCache, "import_new_pubkeys", "pubkey_import")]
                         + [(sigs, name, "build_sets") for name in builders])

    saved = (bls.verify_signature_sets, engine.device_build_levels, ev._device_altair_deltas)
    bls.verify_signature_sets = capture("sets", saved[0])
    engine.device_build_levels = capture("leaves", saved[1])
    ev._device_altair_deltas = capture("epoch", saved[2])
    routes_before, epoch_before = router.route_totals(), ev.epoch_totals()
    walls, timers = {}, {"advance": CallTimer([(sl, "process_epoch", "epoch")]),
                         "gossip_verify": split_timer(), "process_block": split_timer()}

    def import_block():
        with timers["advance"]:
            walls["advance"] = advance(chain)
        t = time.perf_counter()
        chain.slot_clock.set_slot(slot)
        chain.per_slot_task()
        walls["per_slot_task"] = time.perf_counter() - t
        with timers["gossip_verify"]:
            t = time.perf_counter()
            got = chain.verify_block_for_gossip(signed)
            walls["gossip_verify"] = time.perf_counter() - t
        with timers["process_block"]:
            t = time.perf_counter()
            chain.process_block(signed, block_root=got, proposal_already_verified=True)
            walls["process_block"] = time.perf_counter() - t
        return got

    # the block's signatures stay cached as block_mainnet's import left
    # them: their decompression (~23-27 s) is timed there
    try:
        got, wall_s = drive("beacon_chain", BEACON_CHAIN_PATH, import_block)
    finally:
        bls.verify_signature_sets, engine.device_build_levels, ev._device_altair_deltas = saved
    # the signers of the singles start beside the checks below (spawned,
    # not forked: this process holds the card and its threads)
    pool = mp.get_context("spawn").Pool(SIGN_WORKERS)
    routes = {k: v - routes_before.get(k, 0) for k, v in router.route_totals().items()
              if v != routes_before.get(k, 0)}
    epochs = {k: v - epoch_before.get(k, 0) for k, v in ev.epoch_totals().items()}
    import_sets = max(captured["sets"], key=len)
    head = chain.head_state()
    state_root = types.BeaconState.hash_tree_root(head)
    t0 = time.perf_counter()
    stored_block = chain.store.get_block(root, types)
    stored_state = chain.store.get_state(state_root, types)
    store_ok = (stored_block is not None and stored_state is not None
                and types.SignedBeaconBlock.serialize(stored_block)
                == types.SignedBeaconBlock.serialize(signed)
                and types.BeaconState.hash_tree_root(stored_state) == state_root)
    store_read_s = time.perf_counter() - t0

    def split_of(name):
        T = timers[name].seconds
        parts = {k: T.get(k, 0.0) for k in ("state_for_block", "build_sets", "batch_verify",
                                            "marshal", "store_writes", "fork_choice",
                                            "pubkey_import")}
        parts["dispatch_to_verdict"] = parts["batch_verify"] - parts["marshal"]
        parts["rest"] = walls[name] - sum(parts[k] for k in (
            "state_for_block", "build_sets", "batch_verify", "store_writes", "fork_choice",
            "pubkey_import"))
        return {"wall": walls[name], **parts}

    checks = {"got_is_block_root": got == root, "head_is_block": chain.head_root == root,
              "fork_choice_head": chain.fork_choice.get_head() == root,
              "state_root_is_blocks": state_root == bytes(signed.message.state_root),
              "state_root_is_block_mainnets": state_root == post_root,
              "store_returns_block_and_state": store_ok,
              "two_batches": [len(x) for x in captured["sets"]] == [1, CHAIN_SETS],
              "bucket": be.padding_bucket(len(import_sets), max(
                  len(x.signing_keys) for x in import_sets)) == BLOCK_BUCKET,
              "device_ok_routes": routes.get("device/ok", 0) > 0,
              "no_device_error": not routes.get("host/device_error"),
              "epoch_device_ok": epochs.get("ok", 0) >= 1 and not epochs.get("error")}

    # the swapped copy on a fresh chain: rejected, the head stays at the anchor
    fresh, fresh_s = new_chain()
    fresh_advance_s = advance(fresh)
    fresh.slot_clock.set_slot(slot)
    fresh.per_slot_task()

    def swapped_import():
        try:
            fresh.process_block(fx.swapped)
        except bc.BlockError as e:
            return str(e)
        return None

    swapped_error, swapped_s = drive("beacon_chain_swapped", MAIN_PATH, swapped_import)
    swapped_root = types.BeaconBlock.hash_tree_root(fx.swapped.message)
    checks.update(swapped_rejected=swapped_error == "block signature batch invalid",
                  swapped_head_at_anchor=fresh.head_root == fresh.genesis_block_root,
                  swapped_not_stored=not fresh.store.block_exists(swapped_root))
    emit({"phase": "beacon_chain", "nvidia_smi": smi, "validators": len(genesis.validators),
          "anchor_slot": chain.anchor_slot, "slot": slot, "sets": len(import_sets),
          "bucket": list(be.padding_bucket(len(import_sets), 512)),
          "chain_init_seconds": init_s, "path_seconds": wall_s,
          "advance_seconds": walls["advance"],
          "advance_epoch_seconds": timers["advance"].seconds.get("epoch", 0.0),
          "import_seconds": walls["per_slot_task"] + walls["gossip_verify"] + walls["process_block"],
          "per_slot_task_seconds": walls["per_slot_task"],
          "split_seconds": {"gossip_verify": split_of("gossip_verify"),
                            "process_block": split_of("process_block")},
          "store_read_seconds": store_read_s, "swapped_error": swapped_error,
          "swapped_seconds": swapped_s, "fresh_chain_init_seconds": fresh_s,
          "fresh_advance_seconds": fresh_advance_s,
          "routes": routes, "epoch_device_totals": epochs, "checks": checks,
          "launches": launches["beacon_chain"]})
    if not all(checks.values()):
        raise SystemExit(f"the beacon_chain path failed its checks: {checks}")

    # SINGLES unaggregated attestations of slot 64 for the head, one key
    # each, and the SINGLES_BAD-th once more by the next validator's key
    epoch = h.compute_epoch_at_slot(slot, spec)
    cache = acc.build_committee_cache(head, spec, epoch)
    domain = h.get_domain(head, spec, DOMAIN_BEACON_ATTESTER, epoch)
    target = types.Checkpoint.make(epoch=epoch, root=root)
    datas = [types.AttestationData.make(
        slot=slot, index=c, beacon_block_root=root, source=head.current_justified_checkpoint,
        target=target) for c in range(cache.committees_per_slot)]
    members, jobs = [], []
    for k in range(SINGLES):
        c, pos = k % cache.committees_per_slot, k // cache.committees_per_slot
        committee = cache.committee(slot, c)
        members.append((c, pos, len(committee), committee[pos]))
        jobs.append((fx.keypairs[committee[pos]].sk.scalar,
                     h.compute_signing_root(types.AttestationData, datas[c], domain)))
    wrong = (members[SINGLES_BAD][3] + 1) % len(fx.keypairs)
    jobs.append((fx.keypairs[wrong].sk.scalar, jobs[SINGLES_BAD][1]))
    t0 = time.perf_counter()
    with pool:
        signatures = pool.starmap(bf.sign_root, jobs, chunksize=1)
    sign_s = time.perf_counter() - t0

    def single(k, sig):
        c, pos, size, _v = members[k]
        return types.Attestation.make(aggregation_bits=[i == pos for i in range(size)],
                                      data=datas[c], signature=sig)

    singles = [single(k, signatures[k]) for k in range(SINGLES)]
    bad = singles[:SINGLES_BAD] + [single(SINGLES_BAD, signatures[-1])] + singles[SINGLES_BAD + 1:]
    want = [[v] for *_rest, v in members]

    def verdicts(results):
        return [(types.Attestation.hash_tree_root(a), list(i)) for a, i in results]

    captured["sets"].clear()
    bls.verify_signature_sets = capture("sets", saved[0])
    a_timer = CallTimer([(bc.BeaconChain, "prepare_unaggregated_attestations", "prepare"),
                         (bls, "verify_signature_sets", "batch_verify"),
                         (backend, "marshal", "marshal"),
                         (bc.BeaconChain, "complete_attestation_batch", "complete"),
                         (bc.BeaconChain, "apply_attestation_to_fork_choice", "fork_choice")])

    def attest():
        with a_timer:
            verified = chain.verify_unaggregated_attestations(singles)
            for att, indices in verified:
                chain.apply_attestation_to_fork_choice(att, indices)
        t = time.perf_counter()
        again = chain.verify_unaggregated_attestations(singles)
        return verified, again, time.perf_counter() - t

    try:
        (verified, again, again_s), attest_s = drive("beacon_chain_attestations", MAIN_PATH, attest)
        singles_sets = captured["sets"][0] if len(captured["sets"]) == 1 else []

        # one signed by the wrong key, on a chain from the checkpoint: the
        # per-set fallback keeps the others
        captured["sets"].clear()
        bad_chain, bad_init_s = checkpoint_chain(head)
        kept, bad_s = drive("beacon_chain_bad_single", MAIN_PATH,
                            lambda: bad_chain.verify_unaggregated_attestations(bad))
        fallback = [len(x) for x in captured["sets"]]
    finally:
        bls.verify_signature_sets = saved[0]

    # the dispatcher's path on another such chain
    disp_chain, disp_init_s = checkpoint_chain(head)

    def dispatched():
        handle, continuation = disp_chain.submit_attestation_batch(singles)
        ok = handle.result()
        results, done = continuation(ok), []
        repeat = disp_chain.submit_attestation_batch(singles, on_done=done.append)
        return ok, results, repeat, done

    (disp_ok, disp_results, disp_repeat, disp_done), disp_s = drive(
        "beacon_chain_dispatcher", MAIN_PATH, dispatched)
    T = a_timer.seconds
    a_split = {"prepare": T.get("prepare", 0.0), "batch_verify": T.get("batch_verify", 0.0),
               "marshal": T.get("marshal", 0.0),
               "dispatch_to_verdict": T.get("batch_verify", 0.0) - T.get("marshal", 0.0),
               "complete": T.get("complete", 0.0), "fork_choice": T.get("fork_choice", 0.0)}
    singles_bucket = (be.padding_bucket(len(singles_sets), max(
        len(x.signing_keys) for x in singles_sets)) if singles_sets else None)
    a_checks = {"all_verified": [list(i) for _a, i in verified] == want,
                "deduped": again == [],
                "one_batch": len(singles_sets) == SINGLES,
                "bad_kept_the_others": verdicts(kept) == verdicts(
                    [(a, w) for k, (a, w) in enumerate(zip(singles, want)) if k != SINGLES_BAD]),
                "bad_batch_then_per_set": fallback == [SINGLES] + [1] * SINGLES,
                "dispatcher_batch_failed_not": disp_ok is True,
                "dispatcher_same_verdicts": verdicts(disp_results) == verdicts(verified),
                "dispatcher_deduped": disp_repeat is None and disp_done == [[]]}
    emit({"phase": "beacon_chain_attestations", "nvidia_smi": smi, "singles": SINGLES,
          "bucket": list(singles_bucket) if singles_bucket else None,
          "sign_seconds": sign_s, "sign_workers": SIGN_WORKERS, "seconds": attest_s,
          "split_seconds": a_split, "dedup_seconds": again_s, "verified": len(verified),
          "bad": {"index": SINGLES_BAD, "kept": len(kept), "seconds": bad_s,
                  "chain_init_seconds": bad_init_s, "batches": len(fallback)},
          "dispatcher": {"verified": len(disp_results), "seconds": disp_s,
                         "chain_init_seconds": disp_init_s},
          "checks": a_checks, "launches": {p: launches[p] for p in (
              "beacon_chain_attestations", "beacon_chain_bad_single", "beacon_chain_dispatcher")}})
    if not all(a_checks.values()):
        raise SystemExit(f"the beacon_chain attestation paths failed their checks: {a_checks}")

    # each kernel of the path against its plain version at its shapes
    rows, _own, args = check_kernels("beacon_chain", import_sets)
    singles_rows, _own, singles_args = check_kernels("beacon_chain_singles", singles_sets)
    hash_rows, _hash_args = block_path_hash_rows("beacon_chain", captured)

    def profiled_chain_import():
        """The import once more on a fresh chain (advanced to the block's
        slot first), its signatures cached."""
        c, _s = new_chain()
        advance(c)

        def run_import():
            c.slot_clock.set_slot(slot)
            c.per_slot_task()
            c.process_block(signed, block_root=c.verify_block_for_gossip(signed),
                            proposal_already_verified=True)
        return run_import

    handoff = {"head": head, "singles": singles, "bad": bad,
               "validators": [v for *_rest, v in members]}
    return rows, args, singles_rows, singles_args, hash_rows, profiled_chain_import, handoff


def beacon_processor_phase(drive, launches, check_kernels, checked_buckets, smi, fx, handoff):
    """Gossip attestations the way a node takes them, on "torch" and the
    "device" hash backend, on beacon_chain's fixture, imported block and
    singles (the singles' signatures dropped from the cache first, so the
    first pass decompresses them as a node first does; later passes reuse
    them):

    1. live: a chain from the imported block (from_checkpoint) with an
       OperationPool; a BeaconProcessor behind an AdmissionController on
       the chain's clock, its workers started; each single published as
       snappy-compressed SSZ on its attestation subnet through the
       InProcessGossipRouter; the subscriber submits a WorkItem with the
       admission deadline whose batch runner is one
       submit_attestation_batch, its continuation putting the verified
       ones in the pool; drain, stop. All processed, none dropped, expired
       or shed, every verdict true, the votes in fork choice, the pool
       holding all, no processor error;
    2. the copy with one single signed by a wrong key on a fresh chain,
       run_until_idle: the batch fails, the per-set fallback (on the card)
       keeps the other SINGLES - 1, and only those reach the pool;
    3. observability.pipeline.run_probe: its count, every pipeline stage
       in snapshot()["stages"];
    4. produce_block at the next slot on pass 1's chain and pool, the
       RANDAO reveal and the block signed in-process by the proposer's key:
       its attestations cover exactly the singles' validators;
    5. the signed block imported through per_slot_task,
       verify_block_for_gossip and process_block by a chain on HotColdDB
       over two NativeKVStores (the g++ build, not the pure-Python
       fallback), anchored at genesis and past the fixture's block
       (genesis_native_chain): the head, its state root, the stored block,
       and fsck_datadir clean after the chain persists.
    Each pass is driven with the launch counts reset; every kernel of
    PROCESSOR_PATH launched in the phase. Then each path kernel against its
    plain version at every bucket the phase's batches ran that no earlier
    phase held (`checked_buckets`), and the ladder at the widths it hashed.
    Returns those rows by bucket, the ladder's rows and the import to
    profile."""
    import atexit
    import shutil
    import tempfile

    from lighthouse_tpu_torch import observability
    from lighthouse_tpu_torch.chain import beacon_chain as bc
    from lighthouse_tpu_torch.chain import beacon_processor as bp
    from lighthouse_tpu_torch.chain.op_pool import OperationPool
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls381 import serde
    from lighthouse_tpu_torch.crypto.torchbls import backend as be
    from lighthouse_tpu_torch.fork_choice.fork_choice import ForkChoice
    from lighthouse_tpu_torch.network import gossip, snappy
    from lighthouse_tpu_torch.observability import pipeline, trace
    from lighthouse_tpu_torch.qos.admission import AdmissionController
    from lighthouse_tpu_torch.ssz.core import uint64
    from lighthouse_tpu_torch.state_transition import accessors as acc
    from lighthouse_tpu_torch.state_transition import signature_sets as sigs
    from lighthouse_tpu_torch.state_transition import slot as sl
    from lighthouse_tpu_torch.store import doctor, native_kv
    from lighthouse_tpu_torch.store.hot_cold import HotColdDB
    from lighthouse_tpu_torch.testing import block_fixtures as bf
    from lighthouse_tpu_torch.torchhash import engine
    from lighthouse_tpu_torch.torchhash import epoch_vectors as ev
    from lighthouse_tpu_torch.torchhash import router
    from lighthouse_tpu_torch.types import helpers as h
    from lighthouse_tpu_torch.types.spec import DOMAIN_BEACON_PROPOSER, DOMAIN_RANDAO
    from lighthouse_tpu_torch.types.state_util import clone_state

    spec, signed = fx.spec, fx.block
    head, singles, bad = handoff["head"], handoff["singles"], handoff["bad"]
    validators = sorted(handoff["validators"])
    router.set_hash_backend("device")
    bls.set_backend("torch")
    backend = bls.get_backend()
    slot = int(signed.message.slot)
    root = fx.types.BeaconBlock.hash_tree_root(signed.message)
    kind = bp.WorkKind.gossip_attestation
    digest = h.compute_fork_digest(spec.fork_version(spec.fork_name_at_slot(slot)),
                                   bytes(head.genesis_validators_root))

    def checkpoint_chain(**kw):
        """A chain started from the imported block and its post-state."""
        t = time.perf_counter()
        chain = bc.BeaconChain.from_checkpoint(spec, clone_state(head, spec), signed, **kw)
        chain.slot_clock.set_slot(slot)
        chain.per_slot_task()
        return chain, time.perf_counter() - t

    # every batch's sets, and the device tree builds' leaves and the epoch
    # leg's arrays (their callers wrapped: the kernel wrappers count launches)
    captured = {"sets": [], "leaves": [], "epoch": []}

    def capture(label, fn):
        def wrapped(*args, **kwargs):
            captured[label].append(list(args[0]) if label == "sets" else args)
            return fn(*args, **kwargs)
        return wrapped

    def errors():
        return {key: child.value for key, child in bp._ERRORS.children()}

    def genesis_native_chain(datadir):
        """A chain on HotColdDB over two NativeKVStores in datadir, anchored
        at the fixture's genesis, then the imported block imported. A chain
        from the checkpoint would not do: its anchor's epoch is taken as
        finalized, and a block whose post-state finalized epoch 0 never
        becomes head (in the JAX package's chain too). The state-advance
        timer's entry for the genesis head is the fixture's pre-state (the
        genesis state advanced through the empty slots) advanced one slot:
        the state advance_head_state computes, without its 63 slots again."""
        t0 = time.perf_counter()
        stores = tuple(native_kv.NativeKVStore(os.path.join(datadir, name))
                       for name in doctor.DB_FILES)
        c = bc.BeaconChain(spec, clone_state(fx.genesis_state, spec),
                           store=HotColdDB(spec, hot=stores[0], cold=stores[1]))
        t1 = time.perf_counter()
        advanced = clone_state(fx.pre_state, spec)
        sl.process_slots(advanced, spec, slot)
        c._advanced = {c.genesis_block_root: advanced}
        t2 = time.perf_counter()
        c.slot_clock.set_slot(slot)
        c.per_slot_task()
        c.process_block(signed, block_root=c.verify_block_for_gossip(signed),
                        proposal_already_verified=True)
        if c.head_root != root:
            raise SystemExit("the native chain did not import the fixture's block")
        return c, stores, {"open_and_anchor": t1 - t0, "advance": t2 - t1,
                           "import_parent": time.perf_counter() - t2}

    def gossip_into(chain, proc, pool, atts, oks, verified, settled):
        """node.py's attestation handler and batch runner, without
        gossipsub: publish each single on its subnet; the subscriber
        deserialises it and submits a WorkItem with its deadline; the
        runner makes one submit_attestation_batch whose continuation
        records the verdict and puts the verified ones in the pool.
        `settled` counts the singles whose batch has come to an end."""
        types = sl.types_for_slot(spec, chain.current_slot)
        cps = acc.build_committee_cache(chain.head_state(), spec,
                                        h.compute_epoch_at_slot(slot, spec)).committees_per_slot
        net, topics = gossip.InProcessGossipRouter(), set()

        def run_batch(payloads):
            def on_done(results):
                for att, indices in results:
                    pool.insert_attestation(att, indices, types)
                verified.extend(results)

            pair = chain.submit_attestation_batch(list(payloads), on_done=on_done)
            if pair is None:
                settled.append(len(payloads))
                return None
            handle, cont = pair

            def continuation(ok):
                oks.append(ok)
                try:
                    return cont(ok)
                finally:
                    settled.append(len(payloads))
            return handle, continuation

        def on_attestation(msg):
            try:
                att = types.Attestation.deserialize(snappy.decompress(msg.payload))
            except Exception:
                return False
            return proc.submit(bp.WorkItem(
                kind=kind, payload=att, run_batch=run_batch,
                deadline_slot=proc.admission.attestation_deadline_slot(att.data.slot)))

        t = time.perf_counter()
        for att in atts:
            topic = gossip.attestation_subnet_topic(digest, gossip.compute_subnet_for_attestation(
                cps, int(att.data.slot), int(att.data.index), spec))
            if topic not in topics:
                topics.add(topic)
                net.subscribe("node", topic, on_attestation)
            net.publish("peer", topic, types.Attestation.serialize(att))
        return net, len(topics), t

    def batch_traces(before):
        """The processor's traces completed since `before`: their sizes and
        the seconds of each pipeline stage."""
        ring = trace.TRACER.snapshot_ring()
        done = ring[len(ring) - min(len(ring), trace.TRACER.completed - before):]
        return [{"kind": tr.kind, "items": tr.n_items,
                 **{name: t1 - t0 for name, t0, t1, _a in tr.spans}} for tr in done
                if tr.kind == kind.name]

    def split_timer(extra=()):
        return CallTimer([(serde, "g2_decompress", "decompress"),
                          (bc.BeaconChain, "prepare_unaggregated_attestations", "prepare"),
                          (backend, "marshal", "marshal"),
                          (bls, "verify_signature_sets", "batch_verify"),
                          (bc.BeaconChain, "_state_for_block", "state_for_block"),
                          (HotColdDB, "put_block", "store_writes"),
                          (HotColdDB, "put_state", "store_writes"),
                          (ForkChoice, "on_block", "fork_choice"),
                          (bc.BeaconChain, "recompute_head", "fork_choice")] + list(extra))

    saved = (bls.verify_signature_sets, bls.verify_signature_sets_async,
             engine.device_build_levels, ev._device_altair_deltas)
    bls.verify_signature_sets = capture("sets", saved[0])
    bls.verify_signature_sets_async = capture("sets", saved[1])
    engine.device_build_levels = capture("leaves", saved[2])
    ev._device_altair_deltas = capture("epoch", saved[3])
    out, tmp = {}, tempfile.mkdtemp(prefix="beacon-processor-")
    atexit.register(shutil.rmtree, tmp, True)
    try:
        # the import's chain on a native store, built first: the imported
        # block's signatures are still cached
        native_chain = genesis_native_chain(os.path.join(tmp, "import"))
        for got in captured.values():         # their batches are not this phase's
            got.clear()
        # the singles as a node first sees them; the imported block's
        # signatures stay cached for the profiled imports at the end
        fresh = {bytes(a.signature) for a in singles + bad}
        for key in [k for k in bls.Signature._CACHE if k[0] in fresh]:
            del bls.Signature._CACHE[key]

        # 1. live: the workers started, the singles published, drain, stop
        chain, init_s = checkpoint_chain()
        pool = OperationPool(spec)
        proc = bp.BeaconProcessor(bp.BeaconProcessorConfig(),
                                  admission=AdmissionController(chain.slot_clock))
        errors_before, traces_before = errors(), trace.TRACER.completed
        oks, verified, settled, timer = [], [], [], split_timer()

        def live():
            proc.start()
            try:
                with timer:
                    net, subnets, t = gossip_into(chain, proc, pool, singles, oks, verified,
                                                  settled)
                    drained = proc.drain(timeout=PROCESSOR_DRAIN_S)
                    # drain() returns once the queues and the in-flight
                    # window are empty, which a worker still running a
                    # batch's runner is neither in: wait for every batch's end
                    while sum(settled) < net.delivered or not proc.queues_empty():
                        if time.perf_counter() - t > PROCESSOR_DRAIN_S:
                            break
                        time.sleep(0.005)
                    wall = time.perf_counter() - t
            finally:
                proc.stop()
            return net, subnets, drained, wall

        (net, subnets, drained, live_wall), live_s = drive("beacon_processor", MAIN_PATH, live)
        stats = proc.stats()
        traces = batch_traces(traces_before)
        q = chain.fork_choice._queued
        queued_votes = sorted(i for a in q for i in a.attesting_indices)
        T = timer.seconds
        pooled = sorted(i for bucket in pool.attestations.values() for e in bucket
                        for i in e.attesting_indices)
        live_checks = {
            "published": net.delivered == len(singles),
            "processed": stats["processed"] == {kind.name: len(singles)},
            "none_dropped_expired_shed": not (stats["dropped"] or stats["expired"]
                                              or stats["shed_admission"]),
            "drained": bool(drained) and proc.queues_empty() and sum(settled) == len(singles),
            "every_verdict_true": bool(oks) and all(oks) and len(oks) == len(traces),
            "all_verified": sorted(i for _a, (i,) in verified) == validators,
            "votes_queued_in_fork_choice": queued_votes == validators,
            "pool_holds_all": pooled == validators,
            "no_processor_error": errors() == errors_before,
        }
        out["live"] = {
            "chain_init_seconds": init_s, "path_seconds": live_s, "subnets": subnets,
            "workers": proc.config.num_workers, "max_inflight": proc.config.max_inflight,
            "batches": [t["items"] for t in traces], "batches_formed": stats["batches_formed"],
            "pipelined_batches": stats["pipelined_batches"],
            "scheduler": {k: stats["scheduler"][k] for k in ("caps", "decisions", "model")},
            "queue_wait_seconds": [t.get("enqueue") for t in traces],
            "stage_seconds": {s: sum(t.get(s, 0.0) for t in traces)
                              for s in trace.PIPELINE_STAGES},
            "wall_seconds": live_wall,
            "split_seconds": {"decompress": T.get("decompress", 0.0),
                              "prepare": T.get("prepare", 0.0),
                              "marshal": T.get("marshal", 0.0),
                              "dispatch_to_verdict": sum(t.get("device", 0.0) for t in traces)},
            "checks": live_checks}

        # 2. the bad single, deterministic mode, on a fresh chain
        chain2, init2_s = checkpoint_chain()
        pool2 = OperationPool(spec)
        proc2 = bp.BeaconProcessor(bp.BeaconProcessorConfig(),
                                   admission=AdmissionController(chain2.slot_clock))
        oks2, verified2, n_sets = [], [], len(captured["sets"])

        def bad_pass():
            net2, _subnets, _t = gossip_into(chain2, proc2, pool2, bad, oks2, verified2, [])
            return net2, proc2.run_until_idle()

        (net2, executed2), bad_s = drive("beacon_processor_bad_single", MAIN_PATH, bad_pass)
        bad_validator = validators.index(handoff["validators"][SINGLES_BAD])
        kept = sorted(i for _a, (i,) in verified2)
        pooled2 = sorted(i for b in pool2.attestations.values() for e in b
                         for i in e.attesting_indices)
        fallback = [len(x) for x in captured["sets"][n_sets:]]
        out["bad_single"] = {
            "chain_init_seconds": init2_s, "seconds": bad_s, "executed": executed2,
            "kept": len(kept), "batches": fallback[:1], "per_set_verifies": len(fallback) - 1,
            "signature_cache": "reused (the bad single's one signature decompressed anew)",
            "checks": {"batch_failed": oks2 == [False],
                       "kept_the_others": kept == validators[:bad_validator]
                       + validators[bad_validator + 1:],
                       "pool_holds_only_those": pooled2 == kept,
                       "batch_then_per_set": fallback == [SINGLES] + [1] * SINGLES,
                       "processed": proc2.stats()["processed"] == {kind.name: SINGLES},
                       "no_processor_error": errors() == errors_before}}

        # 3. the probe
        n_sets = len(captured["sets"])
        executed3, probe_s = drive("beacon_processor_probe", MAIN_PATH,
                                   lambda: pipeline.run_probe(PROBE_ITEMS))
        snap = observability.snapshot()
        out["probe"] = {"executed": executed3, "seconds": probe_s, "stages": snap["stages"],
                        "batches": [len(x) for x in captured["sets"][n_sets:]],
                        "checks": {"executed": executed3 >= 1,
                                   "every_stage": snap["stages"] == list(trace.PIPELINE_STAGES)}}

        # 4. produce_block at the next slot on pass 1's chain and pool
        next_slot = slot + 1
        chain.slot_clock.set_slot(next_slot)
        chain.per_slot_task()
        votes = chain.fork_choice.proto.votes
        votes_applied = all(v < len(votes) and votes[v].next_root == root for v in validators)
        t0 = time.perf_counter()
        st = clone_state(chain.head_state(), spec)
        sl.process_slots(st, spec, next_slot)
        proposer = acc.get_beacon_proposer_index(st, spec)
        epoch = h.compute_epoch_at_slot(next_slot, spec)
        sk = fx.keypairs[proposer].sk.scalar
        reveal = bf.sign_root(sk, h.compute_signing_root(
            uint64, epoch, h.get_domain(st, spec, DOMAIN_RANDAO, epoch)))
        reveal_s = time.perf_counter() - t0
        produce_timer = CallTimer([
            (bc.BeaconChain, "_state_for_block", "state_advance"),
            (OperationPool, "get_attestations_for_block", "packing"),
            (OperationPool, "get_slashings_and_exits", "packing"),
            (bc, "per_block_processing", "block_processing")])

        def produce():
            with produce_timer:
                return chain.produce_block(next_slot, reveal, op_pool=pool)

        block, produce_s = drive("beacon_processor_produce", PRODUCE_PATH, produce)
        types = sl.types_for_slot(spec, next_slot)
        t0 = time.perf_counter()
        block_sig = bf.sign_root(sk, h.compute_signing_root(
            types.BeaconBlock, block, h.get_domain(st, spec, DOMAIN_BEACON_PROPOSER, epoch)))
        sign_s = time.perf_counter() - t0
        produced = types.SignedBeaconBlock.make(message=block, signature=block_sig)
        packed = sorted(i for a in block.body.attestations
                        for i in acc.get_attesting_indices(st, spec, a.data, a.aggregation_bits))
        P = produce_timer.seconds
        out["produce"] = {
            "slot": next_slot, "proposer": proposer, "attestations": len(block.body.attestations),
            "seconds": produce_s, "randao_sign_seconds": reveal_s,
            "block_sign_seconds": sign_s,
            "split_seconds": {"state_advance": P.get("state_advance", 0.0),
                              "packing": P.get("packing", 0.0),
                              "block_processing": P.get("block_processing", 0.0),
                              "post_state_root_and_rest": produce_s - sum(P.values())},
            "checks": {"votes_applied": votes_applied, "packs_the_singles": packed == validators,
                       "proposer_matches": int(block.proposer_index) == proposer}}

        # 5. the produced block's import over the native store
        chain3, (hot, cold), setup3 = native_chain
        n_sets = len(captured["sets"])
        produced_root = types.BeaconBlock.hash_tree_root(block)
        walls, import_timer = {}, split_timer(
            [(sigs, name, "build_sets") for name in (
                "block_proposal_set", "randao_set", "indexed_attestation_set",
                "sync_aggregate_set")])

        def import_produced():
            t = time.perf_counter()
            chain3.slot_clock.set_slot(next_slot)
            chain3.per_slot_task()
            walls["per_slot_task"] = time.perf_counter() - t
            with import_timer:
                t = time.perf_counter()
                got = chain3.verify_block_for_gossip(produced)
                walls["gossip_verify"] = time.perf_counter() - t
                t = time.perf_counter()
                chain3.process_block(produced, block_root=got, proposal_already_verified=True)
                walls["process_block"] = time.perf_counter() - t
            return got

        got, import_s = drive("beacon_processor_import", PROCESSOR_PATH, import_produced)
        import_sets = max(captured["sets"][n_sets:], key=len)
        head3 = chain3.head_state()
        t0 = time.perf_counter()
        chain3.persist()
        persist_s = time.perf_counter() - t0
        stored = chain3.store.get_block(produced_root, types)
        report = doctor.fsck_datadir(os.path.join(tmp, "import"))
        I = import_timer.seconds
        out["import"] = {
            "seconds": import_s, "walls": walls, "chain_setup_seconds": setup3,
            "sets": len(import_sets), "bucket": list(be.padding_bucket(
                len(import_sets), max(len(x.signing_keys) for x in import_sets))),
            "split_seconds": {**{k: I.get(k, 0.0) for k in (
                "decompress", "build_sets", "marshal", "batch_verify", "state_for_block",
                "store_writes", "fork_choice")},
                "dispatch_to_verdict": I.get("batch_verify", 0.0) - I.get("marshal", 0.0)},
            "native_store": {"engine": type(hot).__name__, "build": dict(native_kv.BUILD_INFO),
                             "library": os.path.relpath(str(native_kv._lib_path()), ROOT),
                             "persist_seconds": persist_s,
                             "log_bytes": {n: os.path.getsize(os.path.join(tmp, "import", n))
                                           for n in doctor.DB_FILES}},
            "doctor": {"ok": report["ok"], "problems": report["problems"],
                       "records": {n: v["records"] for n, v in report["logs"].items()},
                       "anchor": report["anchor"]},
            "checks": {"got_is_block_root": got == produced_root,
                       "head_is_block": chain3.head_root == produced_root,
                       "state_root_is_blocks": types.BeaconState.hash_tree_root(head3)
                       == bytes(block.state_root),
                       "store_returns_block": stored is not None
                       and types.SignedBeaconBlock.serialize(stored)
                       == types.SignedBeaconBlock.serialize(produced),
                       "native_not_degraded": type(hot) is native_kv.NativeKVStore
                       and type(cold) is native_kv.NativeKVStore
                       and not native_kv._fallback_warned,
                       "doctor_clean": report["ok"] and not report["problems"]
                       and report["anchor"].get("complete") is True}}
        hot.close()
        cold.close()
    finally:
        (bls.verify_signature_sets, bls.verify_signature_sets_async, engine.device_build_levels,
         ev._device_altair_deltas) = saved

    paths = ("beacon_processor", "beacon_processor_bad_single", "beacon_processor_probe",
             "beacon_processor_produce", "beacon_processor_import")
    phase_launches = {name: sum(launches[p][name] for p in paths) for name in launches[paths[0]]}
    missing = [k for k in PROCESSOR_PATH if not phase_launches[k]]
    emit({"phase": "beacon_processor", "nvidia_smi": smi, "validators": len(head.validators),
          "singles": len(singles), **out,
          "epoch_deltas_launches": phase_launches["epoch_deltas"],
          "launches": {p: {k: v for k, v in launches[p].items() if v} for p in paths}})
    failed = {f"{part}.{name}" for part, o in out.items()
              for name, ok in o.get("checks", {}).items() if not ok}
    if failed or missing:
        raise SystemExit(f"the beacon_processor path failed {sorted(failed)}; "
                         f"kernels not launched: {missing}")

    # each kernel of the path against its plain version at every bucket
    # the phase's batches ran (the first batch of each), and the ladder at
    # every width the phase hashed
    by_bucket = {}
    for sets in captured["sets"]:
        key = be.padding_bucket(len(sets), max(len(x.signing_keys) for x in sets))
        by_bucket.setdefault(key, sets)
    # a bucket an earlier phase of this run held against the plain versions
    # is not run again: each bucket's plain versions take ~30 s on the H100,
    # and with every bucket of this phase the script came within 20 s of
    # its 1200 s limit
    rows, where = {}, {}
    for (n, m), sets in sorted(by_bucket.items()):
        path = f"beacon_processor_{n}x{m}"
        if (n, m) not in checked_buckets:
            rows[path], _own, _args = check_kernels(path, sets)
        where[f"{n}x{m}"] = checked_buckets.setdefault((n, m), path)
    hash_rows, _hash_args = block_path_hash_rows("beacon_processor", captured)
    emit({"phase": "beacon_processor_buckets", "checked_at": where})

    def profiled_processor_import():
        """The produced block's import once more, the singles' signatures
        cached as the gossip pass left them, on a chain from the checkpoint
        over a fresh native store: the same import (the block does not
        become its head, see genesis_native_chain), and quick to build."""
        stores = tuple(native_kv.NativeKVStore(os.path.join(tmp, "profiled", name))
                       for name in doctor.DB_FILES)
        c, _s = checkpoint_chain(store=HotColdDB(spec, hot=stores[0], cold=stores[1]))

        def run_import():
            try:
                c.slot_clock.set_slot(next_slot)
                c.per_slot_task()
                c.process_block(produced, block_root=c.verify_block_for_gossip(produced),
                                proposal_already_verified=True)
            finally:
                for store in stores:
                    store.close()
                shutil.rmtree(tmp, ignore_errors=True)
        return run_import

    return rows, hash_rows, profiled_processor_import


def bn_phase(drive, launches, check_kernels, checked_buckets, smi, fx):
    """`python -m lighthouse_tpu_torch bn` as an operator runs it, on
    block_mainnet's 2^14-validator registry and keys (the mainnet preset,
    deneb from genesis): the fixture's genesis state with its genesis_time
    moved to one slot before the phase (a node started from mainnet's own
    genesis time would advance its head state ~10^8 slots), written as SSZ
    beside the spec's config.yaml. `cli.main(["bn", ...])` runs on this
    thread with the "torch" BLS and "device" hash backends, a native store
    in a temporary datadir, free ports and peer A as its static peer; a
    helper thread drives it:

    1. peer A, an in-process NetworkNode on its own BeaconChain from the
       same genesis, publishes SINGLES single attestations of slot 0 over
       gossip (16 of each of slot 0's committees, signed on SIGN_WORKERS
       spawned processes); the node's BeaconProcessor verifies them on the
       card in the batches its scheduler forms: all processed, none
       dropped, expired or shed, all in the op pool the node serves from
       (the reference's API has no GET for the attestation pool);
    2. GET /eth/v3/validator/blocks/1 with the proposer's RANDAO reveal,
       the block signed by its proposer, POST /eth/v2/beacon/blocks: the
       node imports it on the card; its attestations cover exactly the
       singles' validators; /eth/v1/beacon/headers/head and
       /eth/v1/beacon/states/head/root give its root and state root;
       /eth/v1/node/peer_count and a /metrics scrape (beacon_head_slot 1)
       answer;
    3. peer B, a fresh in-process node, dials the node and range-syncs
       block 1 over Req/Resp into process_chain_segment on the card: its
       head is the node's;
    4. SIGTERM: cli.main returns 0, the log says "chain persisted; store
       flushed and closed", store.doctor.fsck_datadir comes back clean.
    A failure of the helper still raises SIGTERM; the phase then fails
    after cli.main returns. The whole run is one path, driven with the
    launch counts reset (the peers are built before it); every kernel of
    BN_PATH must launch. Then each path kernel against its plain version
    at every bucket the phase's batches ran that no earlier phase held,
    and the ladder at the widths it hashed. Returns those rows by bucket
    and the ladder's rows."""
    import multiprocessing as mp
    import shutil
    import signal
    import tempfile
    import threading
    import urllib.request

    from lighthouse_tpu_torch import cli
    from lighthouse_tpu_torch.api import client as api_client
    from lighthouse_tpu_torch.autotune import runtime as at_runtime
    from lighthouse_tpu_torch.api import http_api
    from lighthouse_tpu_torch.chain import beacon_chain as bc
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls381 import serde
    from lighthouse_tpu_torch.crypto.torchbls import backend as be
    from lighthouse_tpu_torch.network import gossip, transport
    from lighthouse_tpu_torch.network.node import NetworkNode
    from lighthouse_tpu_torch.observability import flight_recorder, trace
    from lighthouse_tpu_torch.ssz.core import uint64
    from lighthouse_tpu_torch.state_transition import accessors as acc
    from lighthouse_tpu_torch.state_transition import slot as sl
    from lighthouse_tpu_torch.store import doctor
    from lighthouse_tpu_torch.testing import block_fixtures as bf
    from lighthouse_tpu_torch.torchhash import engine
    from lighthouse_tpu_torch.torchhash import epoch_vectors as ev
    from lighthouse_tpu_torch.types import helpers as h
    from lighthouse_tpu_torch.types import network_config
    from lighthouse_tpu_torch.types.spec import (DOMAIN_BEACON_ATTESTER, DOMAIN_BEACON_PROPOSER,
                                                 DOMAIN_RANDAO)
    from lighthouse_tpu_torch.types.state_util import clone_state
    from lighthouse_tpu_torch.utils import logging as lg
    from lighthouse_tpu_torch.utils import metrics as um
    from lighthouse_tpu_torch.utils.slot_clock import SystemTimeSlotClock

    tmp = tempfile.mkdtemp(prefix="bn-")
    # the singles' signers (spawned: this process holds the card and its
    # threads) import while the genesis and the peers are built
    pool = mp.get_context("spawn").Pool(SIGN_WORKERS)
    try:
        # the spec as a config.yaml, read back as the node reads it
        config_path = os.path.join(tmp, "config.yaml")
        with open(config_path, "w") as f:
            f.write(network_config.config_to_yaml(fx.spec))
        with open(config_path) as f:
            spec = network_config.config_from_yaml(f.read())
        types = sl.types_for_slot(spec, 0)
        genesis = clone_state(fx.genesis_state, spec)
        genesis.genesis_time = int(time.time()) - spec.seconds_per_slot
        state_path = os.path.join(tmp, "genesis.ssz")
        with open(state_path, "wb") as f:
            f.write(types.BeaconState.serialize(genesis))

        def peer(name):
            """A node of its own on a chain from the same genesis, on the
            wall clock, its p2p stack on a free port."""
            chain = bc.BeaconChain(spec, clone_state(genesis, spec), slot_clock=SystemTimeSlotClock(
                int(genesis.genesis_time), spec.seconds_per_slot))
            digest = h.compute_fork_digest(spec.fork_version(spec.fork_name_at_slot(0)),
                                           bytes(genesis.genesis_validators_root))
            return NetworkNode(chain, name, fork_digest=digest)

        t0 = time.perf_counter()
        node_a, node_b = peer("peer-a"), peer("peer-b")
        peers_s = time.perf_counter() - t0
        chain_a = node_a.chain
        root0 = chain_a.genesis_block_root

        # SINGLES single attestations of slot 0, signed on spawned processes
        # while the node starts
        head = chain_a.head_state()
        cache = acc.build_committee_cache(head, spec, 0)
        domain = h.get_domain(head, spec, DOMAIN_BEACON_ATTESTER, 0)
        target = types.Checkpoint.make(epoch=0, root=root0)
        datas = [types.AttestationData.make(
            slot=0, index=c, beacon_block_root=root0, source=head.current_justified_checkpoint,
            target=target) for c in range(cache.committees_per_slot)]
        members, jobs = [], []
        for k in range(SINGLES):
            c, pos = k % cache.committees_per_slot, k // cache.committees_per_slot
            committee = cache.committee(0, c)
            members.append((c, pos, len(committee), committee[pos]))
            jobs.append((fx.keypairs[committee[pos]].sk.scalar,
                         h.compute_signing_root(types.AttestationData, datas[c], domain)))
        validators = sorted(v for *_rest, v in members)
        signing = pool.starmap_async(bf.sign_root, jobs, chunksize=1)

        # the node's own objects, for reading only: serve() and the metrics
        # server's ports, the chain behind them
        seen, ready = {}, threading.Event()
        saved = (http_api.serve, um.metrics_http_server, bls.verify_signature_sets,
                 bls.verify_signature_sets_async, engine.device_build_levels,
                 ev._device_altair_deltas)

        def serve(chain, **kw):
            server, thread, port = saved[0](chain, **kw)
            seen.update(chain=chain, op_pool=kw.get("op_pool"), http_port=port,
                        http_seconds=time.perf_counter() - seen["t_start"])
            return server, thread, port

        def metrics_server(**kw):
            server, port = saved[1](**kw)
            seen["metrics_port"] = port
            ready.set()
            return server, port

        captured = {"sets": [], "leaves": [], "epoch": []}

        def capture(label, fn):
            def wrapped(*args, **kwargs):
                captured[label].append(list(args[0]) if label == "sets" else args)
                return fn(*args, **kwargs)
            return wrapped

        out, marks, failure, main_lock = {}, {}, [], threading.Lock()
        timer = CallTimer([(serde, "g2_decompress", "decompress")])

        def launches_now():
            return {name: k[0].launches for name, k in kernel_registry().items()}

        def wait_for(cond, what, timeout=BN_WAIT_S, poll=0.005):
            t = time.perf_counter()
            while not cond():
                if time.perf_counter() - t > timeout:
                    raise TimeoutError(f"timed out waiting for {what}")
                time.sleep(poll)
            return time.perf_counter() - t

        def get_json(port, path):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
                return json.loads(r.read())

        def drive_node():
            """The helper thread: everything the node is asked, then SIGTERM."""
            try:
                if not ready.wait(BN_WAIT_S):
                    raise TimeoutError("the node never started its servers")
                chain, op_pool = seen["chain"], seen["op_pool"]
                node = chain._network_node
                marks["started"] = launches_now()
                port = seen["http_port"]
                http = api_client.BeaconNodeHttpClient(f"http://127.0.0.1:{port}", timeout=120.0)

                # 1. peer A's gossip into the node's processor
                topics = {gossip.attestation_subnet_topic(node_a.fork_digest,
                                                          gossip.compute_subnet_for_attestation(
                                                              cache.committees_per_slot, 0, c, spec))
                          for c in range(cache.committees_per_slot)}
                mesh_s = wait_for(lambda: topics <= node_a.gossipsub.peer_topics.get(
                    node.node_id, set()), "peer A to learn the node's subnets")
                t = time.perf_counter()
                signatures = signing.get(timeout=BN_WAIT_S)
                sign_wait_s = time.perf_counter() - t
                singles = [types.Attestation.make(
                    aggregation_bits=[i == pos for i in range(size)], data=datas[c],
                    signature=signatures[k]) for k, (c, pos, size, _v) in enumerate(members)]
                traces_before = trace.TRACER.completed
                kind = "gossip_attestation"
                with timer:
                    t_pub = time.perf_counter()
                    for att in singles:
                        node_a.publish_attestation(att, gossip.compute_subnet_for_attestation(
                            cache.committees_per_slot, 0, int(att.data.index), spec))
                    publish_s = time.perf_counter() - t_pub

                    def pooled():
                        return sorted(i for b in list(op_pool.attestations.values())
                                      for e in list(b) for i in e.attesting_indices)

                    wait_for(lambda: node.processor.stats()["processed"].get(kind, 0) >= SINGLES
                             and node.processor.queues_empty() and len(pooled()) == SINGLES,
                             "the singles to reach the node's op pool")
                    gossip_wall = time.perf_counter() - t_pub
                stats = node.processor.stats()
                ring = trace.TRACER.snapshot_ring()
                done = ring[len(ring) - min(len(ring), trace.TRACER.completed - traces_before):]
                batches = [tr for tr in done if tr.kind == kind]
                last_end = max((t1 for tr in batches for _n, _t0, t1, _a in tr.spans), default=t_pub)
                out["gossip"] = {
                    "peers_connected_seconds": mesh_s, "sign_wait_seconds": sign_wait_s,
                    "publish_seconds": publish_s,
                    "first_publish_to_last_batch_end_seconds": last_end - t_pub,
                    "first_publish_to_pool_seconds": gossip_wall,
                    "batches": [tr.n_items for tr in batches],
                    "batch_stage_seconds": [{n: t1 - t0 for n, t0, t1, _a in tr.spans}
                                            for tr in batches],
                    "decompress_seconds": timer.seconds.get("decompress", 0.0),
                    "scheduler": {k: stats["scheduler"][k] for k in ("caps", "decisions")},
                    "checks": {"processed": stats["processed"] == {kind: SINGLES},
                               "none_dropped_expired_shed": not (
                                   stats["dropped"] or stats["expired"]
                                   or stats["shed_admission"]),
                               "pool_holds_the_singles": pooled() == validators}}
                marks["gossip"] = launches_now()

                # 2. produce block 1 over HTTP, sign it, publish it
                t = time.perf_counter()
                wait_for(lambda: (chain.slot_clock.now() or 0) >= 1, "slot 1")
                slot1_wait_s = time.perf_counter() - t
                duties = [d for d in http.proposer_duties(0) if d.slot == 1]
                st = clone_state(genesis, spec)
                sl.process_slots(st, spec, 1)
                proposer = acc.get_beacon_proposer_index(st, spec)
                sk = fx.keypairs[proposer].sk.scalar
                t = time.perf_counter()
                reveal = bf.sign_root(sk, h.compute_signing_root(
                    uint64, 0, h.get_domain(st, spec, DOMAIN_RANDAO, 0)))
                reveal_s = time.perf_counter() - t
                t = time.perf_counter()
                block = http.produce_block(1, reveal, types)
                produce_s = time.perf_counter() - t
                t = time.perf_counter()
                signed = types.SignedBeaconBlock.make(message=block, signature=bf.sign_root(
                    sk, h.compute_signing_root(types.BeaconBlock, block, h.get_domain(
                        st, spec, DOMAIN_BEACON_PROPOSER, 0))))
                sign_s = time.perf_counter() - t
                block_root = types.BeaconBlock.hash_tree_root(block)
                t = time.perf_counter()
                http.publish_block(signed, types)
                publish_block_s = time.perf_counter() - t
                packed = sorted(i for a in block.body.attestations for i in
                                acc.get_attesting_indices(chain.head_state(), spec, a.data,
                                                          a.aggregation_bits))
                header = http.header("head")
                peer_count = get_json(port, "/eth/v1/node/peer_count")["data"]

                def head_slot_lines():
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{seen['metrics_port']}/metrics", timeout=60) as r:
                        return [ln for ln in r.read().decode().splitlines()
                                if ln.startswith("beacon_head_slot ")]

                # the slot timer sets the gauge at its next tick
                metrics_wait_s = wait_for(lambda: head_slot_lines() == ["beacon_head_slot 1"],
                                          "beacon_head_slot 1 on /metrics",
                                          timeout=2 * spec.seconds_per_slot + 5, poll=0.1)
                out["block"] = {
                    "slot1_wait_seconds": slot1_wait_s, "proposer": proposer,
                    "randao_sign_seconds": reveal_s, "produce_seconds": produce_s,
                    "block_sign_seconds": sign_s, "publish_to_import_seconds": publish_block_s,
                    "attestations": len(block.body.attestations), "peer_count": peer_count,
                    "metrics_wait_seconds": metrics_wait_s,
                    "checks": {
                        "proposer_duty": [d.validator_index for d in duties] == [proposer],
                        "packs_the_singles": packed == validators,
                        "imported_as_head": chain.head_root == block_root,
                        "api_head_root": bytes.fromhex(header["root"][2:]) == block_root,
                        "api_state_root": http.state_root("head") == bytes(block.state_root),
                        "peer_count_answers": int(peer_count["connected"]) >= 1,
                        "metrics_head_slot_1": head_slot_lines() == ["beacon_head_slot 1"]}}
                marks["block"] = launches_now()

                # 3. peer B range-syncs block 1 from the node
                host, p2p_port = node.host.listen_addr
                t = time.perf_counter()
                node_b.host.dial(host, p2p_port)
                wait_for(lambda: any(st.head_slot >= 1 for st in node_b.sync.peer_status.values()),
                         "peer B's Status handshake with the node")
                handshake_s = time.perf_counter() - t
                t = time.perf_counter()
                imported = node_b.sync.sync()
                sync_s = time.perf_counter() - t
                out["sync"] = {"handshake_seconds": handshake_s, "seconds": sync_s,
                               "imported": imported,
                               "checks": {"imported_one": imported == 1,
                                          "same_head": node_b.chain.head_root == chain.head_root
                                          == block_root}}
                marks["sync"] = launches_now()
                out["links"] = {
                    "cryptography_available": transport.crypto_available(),
                    "encrypted": {name: sorted(c._tx is not None for c in
                                               n.host.connections.values())
                                  for name, n in (("node", node), ("peer_a", node_a),
                                                  ("peer_b", node_b))}}
                seen["datadir_head"] = chain.head_root
            except BaseException as e:   # reported after cli.main returns
                failure.append(e)
            finally:
                # SIGTERM once cmd_bn's handler is in place, and only while
                # cli.main still runs (the default action would end the script)
                t = time.perf_counter()
                while (signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
                       and not seen.get("main_done") and time.perf_counter() - t < BN_WAIT_S):
                    time.sleep(0.01)
                with main_lock:
                    if not seen.get("main_done"):
                        # to the main thread, which waits in cmd_bn: a signal
                        # raised on this thread would not wake that wait
                        seen["t_signal"] = time.perf_counter()
                        signal.pthread_kill(threading.main_thread().ident, signal.SIGTERM)

        datadir = os.path.join(tmp, "datadir")
        argv = ["bn", "--spec", config_path, "--genesis-state", state_path,
                "--datadir", datadir, "--bls-backend", "torch", "--hash-backend", "device",
                "--zero-ports", "--static-peers", "%s:%d" % node_a.host.listen_addr]
        http_api.serve, um.metrics_http_server = serve, metrics_server
        bls.verify_signature_sets = capture("sets", saved[2])
        bls.verify_signature_sets_async = capture("sets", saved[3])
        engine.device_build_levels = capture("leaves", saved[4])
        ev._device_altair_deltas = capture("epoch", saved[5])
        helper = threading.Thread(target=drive_node, name="bn-helper", daemon=True)

        def run_node():
            seen["t_start"] = time.perf_counter()
            helper.start()
            try:
                return cli.main(argv)
            finally:
                with main_lock:
                    seen["main_done"] = True
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                seen["shutdown_seconds"] = time.perf_counter() - seen.get("t_signal", 0.0)

        try:
            rc, node_s = drive("bn", (), run_node)
        finally:
            (http_api.serve, um.metrics_http_server,
             bls.verify_signature_sets, bls.verify_signature_sets_async,
             engine.device_build_levels, ev._device_altair_deltas) = saved
            helper.join(BN_WAIT_S)
            flight_recorder.RECORDER.configure(incident_dir=None)
            at_runtime.clear()           # the node's scheduler published its retunes
            for n in (node_a, node_b):
                n.close()
        if failure:
            raise SystemExit(f"the bn phase's helper thread failed: {failure[0]!r}") from failure[0]
        missing = [k for k in BN_PATH if launches["bn"][k] <= 0]
        persisted = [rec for rec in list(lg.RECENT)
                     if rec[3] == "chain persisted; store flushed and closed"]
        report = doctor.fsck_datadir(datadir)
        out["shutdown"] = {
            "seconds": seen["shutdown_seconds"], "cli_rc": rc,
            "checks": {"rc_0": rc == 0, "persisted_logged": len(persisted) == 1,
                       "doctor_clean": report["ok"] and not report["problems"]
                       and report["anchor"].get("complete") is True}}
        prev = {}
        by_step = {}
        for step in ("started", "gossip", "block", "sync"):
            by_step[step] = {k: v - prev.get(k, 0) for k, v in marks[step].items()
                             if v != prev.get(k, 0)}
            prev = marks[step]
        emit({"phase": "bn", "nvidia_smi": smi, "validators": len(genesis.validators),
              "argv": argv, "peers_build_seconds": peers_s, "path_seconds": node_s,
              "node_start_to_http_seconds": seen.get("http_seconds"), **out,
              "launches": {k: v for k, v in launches["bn"].items() if v},
              "launches_by_step": by_step})
        failed = {f"{part}.{name}" for part, o in out.items()
                  for name, ok in o.get("checks", {}).items() if not ok}
        if failed or missing:
            raise SystemExit(f"the bn path failed {sorted(failed)}; kernels not launched: {missing}")
    finally:
        pool.terminate()
        pool.join()
        shutil.rmtree(tmp, ignore_errors=True)

    # each kernel of the path against its plain version at every bucket the
    # phase's batches ran that no earlier phase held, and the ladder at
    # every width the phase hashed
    by_bucket = {}
    for sets in captured["sets"]:
        by_bucket.setdefault(be.padding_bucket(len(sets), max(len(x.signing_keys) for x in sets)),
                             sets)
    rows, where = {}, {}
    for (n, m), sets in sorted(by_bucket.items()):
        path = f"bn_{n}x{m}"
        if (n, m) not in checked_buckets:
            rows[path], _own, _args = check_kernels(path, sets)
        where[f"{n}x{m}"] = checked_buckets.setdefault((n, m), path)
    hash_rows, _hash_args = block_path_hash_rows("bn", captured)
    emit({"phase": "bn_buckets", "checked_at": where})
    return rows, hash_rows


def main() -> int:
    try:
        return run()
    finally:
        for proc in CHILDREN:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run() -> int:
    script_t0 = time.perf_counter()
    if not os.path.exists(FIXTURES) or not os.path.isdir(os.path.join(ROOT, "lighthouse_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls381 import hash_to_curve as ph2c
    from lighthouse_tpu_torch.crypto.bls381.constants import DST_POP, P
    from lighthouse_tpu_torch.crypto.torchbls import backend as be
    from lighthouse_tpu_torch.crypto.torchbls import curve_ops as co
    from lighthouse_tpu_torch.crypto.torchbls import kernels as K
    from lighthouse_tpu_torch.crypto.torchbls import limbs as lb
    from lighthouse_tpu_torch.crypto.torchbls import rounds as RD
    from lighthouse_tpu_torch.crypto.torchbls import team as TM
    from lighthouse_tpu_torch.crypto.torchbls import tower as tw
    from lighthouse_tpu_torch.utils import fixtures

    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # the BLS paths' library, latency.cu's and the tree-hash and epoch
    # kernels' (lh_hash), their nvcc runs all started together
    from concurrent.futures import ThreadPoolExecutor

    from lighthouse_tpu_torch.torchhash import kernels as HK

    with ThreadPoolExecutor(3) as pool:
        kl_future, hash_future = pool.submit(K.library), pool.submit(HK.library)
        lat = K.latency_library()
        kl, hl = kl_future.result(), hash_future.result()
    emit({"phase": "build", "nvcc_seconds": round(kl.build_seconds, 3),
          "library": os.path.relpath(str(kl.path), ROOT), "ptxas": ptxas_summary(kl.ptxas_log),
          "latency_library": os.path.relpath(str(lat.path), ROOT),
          "latency_ptxas": ptxas_summary(lat.ptxas_log),
          "hash_library": os.path.relpath(str(hl.path), ROOT),
          "hash_nvcc_seconds": round(hl.build_seconds, 3),
          "hash_ptxas": ptxas_summary(hl.ptxas_log)})
    fixture_proc = start_block_fixture()

    # 2. field self-test and sweep ------------------------------------------
    field_cases = field_phase(dev)

    latency = product_latency(dev)
    emit({"phase": "product_latency", "device": smi, **latency})
    if not all(latency["equal"].values()):
        raise SystemExit(f"product_latency chains disagree with the plain chains: {latency['equal']}")
    inverse = inverse_check(dev)
    emit({"phase": "inverse", **inverse})
    if inverse["differ"] or not inverse["gcd_equal_plain"]:
        raise SystemExit(f"the binary-GCD inversion disagrees with the Fermat chain: {inverse}")

    # fixtures: 64 attestations x 128 keys, the 512-key sync aggregate
    t0 = time.perf_counter()
    groups = fixtures.load_groups(FIXTURES, n_att=N_SETS)
    att, sync = groups["att"], groups["sync"]
    if len(att) != N_SETS or max(len(s.signing_keys) for s in att) != N_PKS:
        raise SystemExit(f"fixture batch is not {N_SETS} x {N_PKS}")
    rand_seed = int.from_bytes(b"chipsmok", "little")

    def rands(n: int) -> list[int]:
        import random

        r = random.Random(rand_seed)
        return [1] + [r.getrandbits(64) | 1 for _ in range(n - 1)]

    # the urgent path's one fixture key, message and signature
    z = np.load(FIXTURES)
    single = fixtures.signature_set(z["small_keys"][0], z["small_sigs"][0], z["small_msgs"][0])
    emit({"phase": "fixtures", "sets": len(att), "pks": N_PKS, "sync_pks": len(sync[0].signing_keys),
          "seconds": time.perf_counter() - t0})

    # 3. each kernel against its plain version on the stage data of each
    # driven bucket: the gossip batch (64, 128), the sync aggregate (4, 512)
    # and the urgent verify (4, 1); AggregateVerify's kernels run at the
    # gossip shapes (64 messages, 65 pairs)
    backend = be.TorchBackend(device="cuda")
    checked_buckets = {}                     # (n, m) -> the first path checked there

    def check_kernels(path: str, sets) -> tuple[dict, dict, dict]:
        """Each kernel's row (measured, with its bound), its schedule
        (counted from the inputs and the programs, not measured) and its
        arguments (the stage data)."""
        prepare_in, us = backend.marshal(sets, rands(len(sets)))
        n, m = prepare_in[0].shape[:2]
        checked_buckets.setdefault((int(n), int(m)), path)
        z_pk, sig_acc, _bad = K.stage_prepare(*prepare_in)
        h_jac = K.hash_to_g2(us)
        pairs = K.stage_pairs(z_pk, h_jac, sig_acc, prepare_in[-1])
        f = K.miller_loop_product(pairs[:2], pairs[2:4], pairs[4])
        t_easy = K.final_exp_easy_part(f)
        cases = {   # fq_mont_mul by R^2 on the u-values: the field phase's kernel at h2c's shape
            "fq_mont_mul": ((us,), us.numel() // lb.NL, 20),
            "stage_prepare": (tuple(prepare_in), fq_products_prepare(*[prepare_in[i] for i in (2, 5, 6)]), 3),
            "hash_to_g2": ((us,), fq_products_h2c(n), 3),
            "stage_pairs": ((z_pk, h_jac, sig_acc, prepare_in[-1]), fq_products_pairs(n), 5),
            "miller_loop_product": ((pairs[:2], pairs[2:4], pairs[4]),
                                    fq_products_miller(pairs[4]), 3),
            "miller_loop_batch": ((pairs[:2], pairs[2:4], pairs[4]),
                                  fq_products_miller_batch(pairs[4]), 3),
            "final_exp_easy_part": ((f,), fq_products_easy_part(), 5),
            "final_exp_hard_part": ((t_easy,), fq_products_hard_part(), 3),
        }
        # the schedule: each kernel's Fq products (the bound's work); the
        # round kernels' own Fq products, the dependent product rounds of
        # the per-pair chain and tree or of the hard part's sequence, and
        # their passes (a block barrier each); the team kernels' dependent
        # levels: prepare's longest G2 chain (a live set's), h2c's per message
        g2_levels = max(TM.chain_levels("g2", b) for b, on in zip(prepare_in[5].tolist(),
                                                                   prepare_in[6].tolist()) if on)
        live, n_pairs = int((pairs[4] != 0).sum()), pairs[0].shape[0]
        own = {"miller_loop_product": {"kernel_fq_products": RD.miller_products(live, n_pairs),
                                       "product_rounds": RD.miller_rounds(n_pairs),
                                       "passes": RD.miller_passes(n_pairs)},
               "miller_loop_batch": {"kernel_fq_products": RD.miller_products(live, 1),
                                     "product_rounds": RD.miller_rounds(1),
                                     "passes": RD.miller_passes(1)},
               "final_exp_hard_part": RD.hard_work(),
               "final_exp_easy_part": RD.easy_work(),
               "stage_prepare": {"g2_chain_levels": g2_levels},
               "hash_to_g2": TM.h2c_levels()}
        # the binary GCDs' integer instructions: one per Z lane, one in the easy part
        int_ops = {"stage_pairs": (2 * n + 1) * int_ops_inverse(),
                   "final_exp_easy_part": int_ops_inverse()}
        rows = {}
        for name, (args, products, reps) in cases.items():
            wrapper, plain, _source, _replaces = K.KERNELS[name]
            kout = wrapper(*args)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pout = plain(*args)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t1) * 1e3
            equal, err = compare(kout, pout)
            ms = cuda_ms(lambda: wrapper(*args), reps)
            bms, by = bound_ms(products, bytes_needed(args) + bytes_needed(kout),
                               int_ops.get(name, 0))
            rows[name] = {"max_abs_err": err, "equal": equal, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bms, "bound_by": by}
            own[name] = {"fq_products": products, **own.get(name, {})}
            if name in int_ops:
                own[name]["inverse_int_ops"] = int_ops[name]
            emit({"phase": "kernel", "path": path, "bucket": [n, m], "name": name, **rows[name]})
            if not equal:
                raise SystemExit(f"{name}: kernel disagrees with its plain version on the {path} path")
        emit({"phase": "schedule", "path": path, "bucket": [n, m], "kernels": own})
        return rows, own, {name: c[0] for name, c in cases.items()}

    checks, schedules, kernel_args = {}, {}, {}
    for path, sets in (("gossip", att), ("sync", sync), ("urgent", [single])):
        checks[path], schedules[path], kernel_args[path] = check_kernels(path, sets)

    # microseconds per product round and per other pass, solved from two
    # kernels that are one block's chain of passes each: the Miller
    # kernel's per-pair phase (slot programs: two-operand linear passes)
    # and the hard part (form programs: each pass evaluates its forms), at
    # the gossip bucket
    (m_r, m_p, m_ms), (h_r, h_p, h_ms) = (
        (schedules["gossip"][k]["product_rounds"], schedules["gossip"][k]["passes"],
         checks["gossip"][k]["ms"]) for k in ("miller_loop_batch", "final_exp_hard_part"))
    det = m_r * (h_p - h_r) - h_r * (m_p - m_r)
    us_round = 1e3 * (m_ms * (h_p - h_r) - h_ms * (m_p - m_r)) / det
    us_pass = 1e3 * (m_r * h_ms - h_r * m_ms) / det
    emit({"phase": "round_costs", "miller_loop_batch": [m_r, m_p - m_r, m_ms],
          "final_exp_hard_part": [h_r, h_p - h_r, h_ms], "us_per_product_round": us_round,
          "us_per_other_pass": us_pass})

    # hash_to_g2 on edge lanes: u = 0 (the xd == 0 case), the EF vectors'
    # messages, and seeded random u-values, among them is_qr true and false
    import random

    from lighthouse_tpu_torch.crypto.bls381 import fields as pyf
    from lighthouse_tpu_torch.testing import ef_bls

    def is_qr(u) -> bool:
        """sqrt_ratio's is_qr for u: whether gx1 of the SWU map is square."""
        Z, A, B = ph2c.ISO_Z, ph2c.ISO_A, ph2c.ISO_B
        tv1 = pyf.fq2_mul(Z, pyf.fq2_sqr(u))
        tv2 = pyf.fq2_add(pyf.fq2_sqr(tv1), tv1)
        xd = pyf.fq2_mul(pyf.fq2_neg(A), tv2)
        if pyf.fq2_is_zero(xd):
            xd = pyf.fq2_mul(Z, A)
        x1 = pyf.fq2_mul(pyf.fq2_mul(B, pyf.fq2_add(tv2, pyf.FQ2_ONE)), pyf.fq2_inv(xd))
        gx1 = pyf.fq2_add(pyf.fq2_mul(pyf.fq2_add(pyf.fq2_sqr(x1), A), x1), B)
        return pyf.fq2_legendre_is_square(gx1)

    ef_msgs = sorted({bytes.fromhex(d["input"]["message"][2:])
                      for _h, _c, p in ef_bls.vector_cases(EF_BLS)
                      for d in [ef_bls.read_data_yaml(p.read_text())]
                      if isinstance(d["input"], dict) and "message" in d["input"]})
    r = random.Random(20261017)
    lanes = [((0, 0), (0, 0))] + [tuple(ph2c.hash_to_field_fq2(msg, 2, DST_POP)) for msg in ef_msgs]
    lanes += [tuple((r.randrange(P), r.randrange(P)) for _ in range(2)) for _ in range(11)]
    qr = [is_qr(u) for lane in lanes for u in lane]
    us_edge = torch.as_tensor(np.stack([
        np.stack([np.stack([lb.pack(u[0]), lb.pack(u[1])]) for u in lane]) for lane in lanes
    ]).astype(np.int64), device=dev)
    kout = K.hash_to_g2(us_edge)
    edge_equal, edge_err = compare(kout, K.hash_to_g2_plain(us_edge))
    x, y, inf = co.jac_to_affine(tuple(c[1:1 + len(ef_msgs)] for c in kout), co.FQ2_OPS)
    xs, ys = lb.from_mont(x).cpu().numpy(), lb.from_mont(y).cpu().numpy()
    ef_python = all(
        ((lb.unpack(xs[i, 0]), lb.unpack(xs[i, 1])), (lb.unpack(ys[i, 0]), lb.unpack(ys[i, 1])))
        == ph2c.hash_to_g2(msg, DST_POP) for i, msg in enumerate(ef_msgs)) and not bool(inf.any())
    emit({"phase": "h2c_edge", "lanes": len(lanes), "ef_messages": len(ef_msgs),
          "u_zero_lanes": 1, "is_qr_true": sum(qr), "is_qr_false": len(qr) - sum(qr),
          "equal": edge_equal, "max_abs_err": edge_err, "ef_match_python": ef_python})
    if not (edge_equal and ef_python and 0 < sum(qr) < len(qr)):
        raise SystemExit("hash_to_g2 fails on the edge lanes")

    # 4. the paths through the public API: each is driven with every launch
    # count set to 0 just before it and read just after, and fails unless
    # every kernel of its list launched in it
    bls.set_backend("torch")
    launches = {}

    def drive(path: str, required, fn, settle: bool = True):
        if settle:                           # start on an idle card
            torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        out = fn()
        seconds = time.perf_counter() - t
        launches[path] = {name: k[0].launches for name, k in kernel_registry().items()}
        missing = [k for k in required if launches[path][k] <= 0]
        if missing:
            raise SystemExit(f"kernels not launched on the {path} path: {missing}")
        return out, seconds

    ok, first_s = drive("gossip", MAIN_PATH, lambda: bls.verify_signature_sets(att, rands))
    if ok is not True:
        raise SystemExit("the 64 x 128 fixture batch did not verify")
    samples = [first_s]                      # the first one marshals the pubkey grid
    for _ in range(VERIFY_REPEATS - 1):
        t0 = time.perf_counter()
        if bls.verify_signature_sets(att, rands) is not True:
            raise SystemExit("a repeated verify of the fixture batch failed")
        samples.append(time.perf_counter() - t0)
    median_s = sorted(samples)[len(samples) // 2]
    n, m = be.padding_bucket(len(att), N_PKS)
    emit({"phase": "main_path", "bucket": [n, m], "verified": ok, "seconds": samples,
          "median_seconds": median_s, "sets_per_s": len(att) / median_s,
          "launches": launches["gossip"]})

    s0 = att[0]
    msg = bytes([s0.message[0] ^ 1]) + s0.message[1:]
    tampered = [bls.SignatureSet(s0.signature, s0.signing_keys, msg)] + att[1:]
    bad_ok, bad_s = drive("tampered", MAIN_PATH, lambda: bls.verify_signature_sets(tampered, rands))
    emit({"phase": "tampered", "verified": bad_ok, "seconds": bad_s, "launches": launches["tampered"]})
    if bad_ok is not False:
        raise SystemExit("the tampered batch verified")

    sync_ok, sync_s = drive("sync", MAIN_PATH, lambda: bls.verify_signature_sets(sync, rands))
    emit({"phase": "sync", "bucket": list(be.padding_bucket(1, len(sync[0].signing_keys))),
          "verified": sync_ok, "seconds": sync_s, "sets_per_s": 1 / sync_s,
          "launches": launches["sync"]})
    if sync_ok is not True:
        raise SystemExit("the sync aggregate did not verify")

    # pipelined: PIPELINED submissions through the dispatcher's window, the
    # 5th tampered; resolving the last ticket first must drain them all in
    # submission order
    dispatcher = bls.get_backend().dispatcher
    batches = [tampered if i == 4 else att for i in range(PIPELINED)]
    expected = [i != 4 for i in range(PIPELINED)]
    submit_s = []

    def pipelined():
        tickets = []
        for batch in batches:
            t = time.perf_counter()
            tickets.append(bls.verify_signature_sets_async(batch, rands))
            submit_s.append(time.perf_counter() - t)
        tickets[-1].result()
        drained = all(t.done for t in tickets)
        return [t.result() for t in tickets], drained

    (verdicts, drained), wall_s = drive("async", MAIN_PATH, pipelined)
    emit({"phase": "pipelined", "bucket": [n, m], "depth": dispatcher.depth,
          "submissions": PIPELINED, "verdicts": verdicts, "fifo_drained": drained,
          "wall_seconds": wall_s, "submit_host_seconds": sum(submit_s),
          "submit_seconds": submit_s, "sets_per_s": PIPELINED * len(att) / wall_s,
          "sync_sets_per_s": len(att) / median_s, "launches": launches["async"]})
    if verdicts != expected or not drained:
        raise SystemExit(f"pipelined verdicts {verdicts}, want {expected} in FIFO order")

    # urgent: one fixture key, message and signature through bls.verify
    # while the batch window is full (its batches still on the card, which
    # has one stream for both lanes), then once more on an idle card
    def verify_single():
        return bls.verify(single.signing_keys[0], single.message, single.signature)

    window = [bls.verify_signature_sets_async(att, rands) for _ in range(dispatcher.depth)]
    inflight = dispatcher.inflight()
    urgent_ok, urgent_s = drive("urgent", MAIN_PATH, verify_single, settle=False)
    window_ok = [t.result() for t in window]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idle_ok = verify_single()
    idle_s = time.perf_counter() - t0
    emit({"phase": "urgent", "verified": urgent_ok, "latency_seconds": urgent_s,
          "batches_in_flight": inflight, "window_verdicts": window_ok,
          "idle_latency_seconds": idle_s, "launches": launches["urgent"]})
    if not (urgent_ok is True and idle_ok is True and inflight == dispatcher.depth
            and all(window_ok)):
        raise SystemExit("the urgent verify failed")

    # aggregate_verify: the 64 sets as one distinct-message AggregateVerify
    from lighthouse_tpu_torch.crypto.bls381 import curve as pc

    agg_pks = []
    for s in att:
        acc = None
        for pk in s.signing_keys:
            acc = pc.g1_add(acc, pk.point)
        agg_pks.append(bls.PublicKey(acc))
    agg_sig = bls.AggregateSignature.aggregate([s.signature for s in att])
    msgs = [s.message for s in att]
    av_ok, av_s = drive("aggregate_verify", AGGREGATE_PATH,
                        lambda: bls.aggregate_verify(agg_pks, msgs, agg_sig))
    av_bad = bls.aggregate_verify(agg_pks, [msg] + msgs[1:], agg_sig)
    emit({"phase": "aggregate_verify", "pairs": len(att) + 1, "verified": av_ok,
          "seconds": av_s, "tampered_verified": av_bad, "launches": launches["aggregate_verify"]})
    if av_ok is not True or av_bad is not False:
        raise SystemExit("AggregateVerify gave a wrong verdict")

    # 5. the EF BLS vectors through the port's API on the card
    t0 = time.perf_counter()
    ef = {f"{h}/{c}": ef_bls.run_vector(p) for h, c, p in ef_bls.vector_cases(EF_BLS)}
    emit({"phase": "ef_bls", "cases": len(ef), "passed": sum(ef.values()),
          "failed": [k for k, v in ef.items() if not v], "seconds": time.perf_counter() - t0})
    if len(ef) != 15 or not all(ef.values()):
        raise SystemExit("EF BLS vectors failed")

    # 6. per-stage times of one more valid batch, synchronised after each stage
    stage_ms = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prepare_in, us = backend.marshal(att, rands(len(att)))
    torch.cuda.synchronize()
    stage_ms["marshal"] = (time.perf_counter() - t0) * 1e3

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        stage_ms[name] = (time.perf_counter() - t) * 1e3
        return out

    z_pk, sig_acc, bad = timed("prepare", be.stage_prepare, *prepare_in)
    h_jac = timed("h2c", be.stage_h2c, us)
    pairs = timed("pairs", be.stage_pairs, z_pk, h_jac, sig_acc, prepare_in[-1])
    f = timed("miller", K.miller_loop_product, pairs[:2], pairs[2:4], pairs[4])
    f = timed("easy_part", K.final_exp_easy_part, f)
    f = timed("hard_part", K.final_exp_hard_part, f)
    okt = timed("check", tw.fq12_eq_one, f)
    emit({"phase": "stages", "bucket": [n, m], "ms": stage_ms,
          "sets_per_s": len(att) / (sum(stage_ms.values()) / 1e3),
          "verified": bool(okt) and not bool(bad)})

    # the hashed message of set 0 against the pure-Python RFC 9380 map
    x, y, inf = co.jac_to_affine(tuple(c[0] for c in h_jac), co.FQ2_OPS)
    got = (tuple(lb.unpack(c.cpu().numpy()) for c in lb.from_mont(x)),
           tuple(lb.unpack(c.cpu().numpy()) for c in lb.from_mont(y)))
    want = ph2c.hash_to_g2(att[0].message, DST_POP)
    emit({"phase": "reference", "h2c_matches_python": got == want and not bool(inf)})
    if got != want or bool(inf):
        raise SystemExit("hash-to-G2 disagrees with the pure-Python reference")

    # the KZG path, after every earlier path's phase so none runs behind
    # its allocations
    msm_rows, msm_args, kzg_verify = kzg_phase(drive, launches, dev)

    # the tree-hash and epoch paths at the mainnet registry's width, then
    # their kernels against the plain versions
    hash_rows, hash_args = hash_phase(drive, launches, dev)

    # the hybrid router over the same card, and the device ledger it books
    hybrid_phase(launches, smi, att, tampered, single, rands, (agg_pks, msgs, agg_sig))

    # the autotune calibrator through the CLI, then per-stage attribution;
    # before the profiler phases, which disturb what follows them
    checks["calibrate"], kernel_args["calibrate"] = calibrate_phase(launches, smi, att, rands,
                                                                    check_kernels)
    attributed_ms = attribution_phase(smi, att, rands)

    # the EF state-transition vectors on the card, then a mainnet block's import
    t0 = time.perf_counter()
    bls.set_backend("torch")
    ef_state_phase(launches)
    ef_state_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (checks["block_mainnet"], kernel_args["block_mainnet"], block_hash_rows, block_hash_args,
     profiled_import, block_fx, block_post_root) = block_mainnet_phase(
        drive, launches, check_kernels, smi, fixture_proc)
    block_mainnet_s = time.perf_counter() - t0
    # the same block and attestations through BeaconChain, on the fixture loaded above
    t0 = time.perf_counter()
    (checks["beacon_chain"], kernel_args["beacon_chain"], checks["beacon_chain_singles"],
     kernel_args["beacon_chain_singles"], chain_hash_rows, profiled_chain_import, handoff) = (
        beacon_chain_phase(drive, launches, check_kernels, smi, block_fx, block_post_root))
    beacon_chain_s = time.perf_counter() - t0
    # gossip through the beacon processor, the op pool, a produced block
    # and its import over the native store, on the chain's fixture and singles
    t0 = time.perf_counter()
    processor_rows, processor_hash_rows, profiled_processor_import = beacon_processor_phase(
        drive, launches, check_kernels, checked_buckets, smi, block_fx, handoff)
    beacon_processor_s = time.perf_counter() - t0
    # the beacon node through its CLI entry point, with its p2p stack, HTTP
    # API and two peers, on the same registry
    t0 = time.perf_counter()
    bn_rows, bn_hash_rows = bn_phase(drive, launches, check_kernels, checked_buckets, smi,
                                     block_fx)
    emit({"phase": "block_phases_seconds", "ef_state": ef_state_s,
          "block_mainnet": block_mainnet_s, "beacon_chain": beacon_chain_s,
          "beacon_processor": beacon_processor_s, "bn": time.perf_counter() - t0})

    # the kernel line: the gossip path's numbers (the MSM kernels': the KZG
    # path's; the tree-hash and epoch kernels': their paths'), then each
    # path's launches and the sync and urgent buckets' checks
    table = {}
    main_paths = {"sha256_ladder": "state_root", "epoch_deltas": "epoch", "sha256_msgs": "state_root"}
    for name, (_w, _p, source, replaces) in kernel_registry().items():
        g = msm_rows.get(name) or hash_rows.get(name) or checks["gossip"][name]
        main_path = "kzg" if name in msm_rows else main_paths.get(name, "gossip")
        table[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[main_path][name],
            "max_abs_err": g["max_abs_err"], "ms": g["ms"], "plain_ms": g["plain_ms"],
            "bound_ms": g["bound_ms"], "bound_by": g["bound_by"], "library_ms": None,
            "equal": g["equal"], "launches_by_path": {path: launches[path][name] for path in launches},
        }
        if name in checks["sync"]:
            table[name].update(sync=checks["sync"][name], urgent=checks["urgent"][name],
                               calibrate=checks["calibrate"][name],
                               block_mainnet=checks["block_mainnet"][name],
                               beacon_chain=checks["beacon_chain"][name],
                               beacon_chain_singles=checks["beacon_chain_singles"][name])
        if name in block_hash_rows:
            table[name]["block_mainnet"] = block_hash_rows[name]
            table[name]["beacon_chain"] = chain_hash_rows[name]
        for path, rows in processor_rows.items():
            if name in rows:
                table[name][path] = rows[name]
        if name in processor_hash_rows:
            table[name]["beacon_processor"] = processor_hash_rows[name]
        for path, rows in bn_rows.items():
            if name in rows:
                table[name][path] = rows[name]
        if name in bn_hash_rows:
            table[name]["bn"] = bn_hash_rows[name]

    # each kernel's device ms from the profiler (prepare's three launches
    # apart) on the stage data of each bucket, beside the CUDA-event ms of
    # back-to-back wrapper calls, which take in the host's time where a
    # wrapper's Python outlasts its kernel; last, so no path above ran in a
    # profiled process
    for path, args_of in kernel_args.items():
        device = {name: profile_ms(name, args) for name, args in args_of.items()}
        emit({"phase": "device_ms", "path": path,
              "bucket": list(args_of["stage_prepare"][0].shape[:2]), "kernels": device})
        for name, d in device.items():
            (table[name] if path == "gossip" else table[name][path])["device_ms"] = d["kernel_ms"]
        if path == "gossip":      # beside the attribution phase's event ms
            kernels_of = {"prepare": ("stage_prepare",), "h2c": ("hash_to_g2",),
                          "pairs": ("stage_pairs",),
                          "pairing": ("miller_loop_product", "final_exp_easy_part",
                                      "final_exp_hard_part")}
            emit({"phase": "attribution_vs_profiler", "bucket": [N_SETS, N_PKS], "stages": {
                stage: {"event_ms": attributed_ms[stage]["event_ms"],
                        "profiler_kernel_ms": sum(device[k]["kernel_ms"] for k in ks)}
                for stage, ks in kernels_of.items()}})
    device = {name: profile_ms(name, args) for name, args in msm_args.items()
              if name != "w_prime"}
    emit({"phase": "device_ms", "path": "kzg", "kernels": device,
          "msm_varying_w_prime": profile_ms("msm_varying", msm_args["w_prime"])})
    for name, d in device.items():
        table[name]["device_ms"] = d["kernel_ms"]
    device = {name: profile_ms(name, args) for name, args in hash_args.items()}
    emit({"phase": "device_ms", "path": "state_root/epoch", "kernels": device})
    for name, d in device.items():
        table[name]["device_ms"] = d["kernel_ms"]
    device = {name: profile_ms(name, args) for name, args in block_hash_args.items()}
    emit({"phase": "device_ms", "path": "block_mainnet (hash)", "kernels": device})
    for name, d in device.items():
        table[name]["block_mainnet"]["device_ms"] = d["kernel_ms"]
    emit_field_device_ms(field_cases)
    emit({"phase": "kzg_device_share", **device_share(kzg_verify)})
    # last: the block imports' long profiler sessions, so no short one follows them
    # the produced block's import first: its singles' signatures are still
    # cached, as the gossip pass left them; the imports after it clear the cache
    emit({"phase": "beacon_processor_device_share", "nvidia_smi": smi,
          **device_share(profiled_processor_import())})
    emit({"phase": "beacon_chain_device_share", "nvidia_smi": smi,
          **device_share(profiled_chain_import())})
    emit({"phase": "block_mainnet_device_share", "nvidia_smi": smi,
          **device_share(profiled_import())})

    emit({"phase": "script_seconds", "seconds": time.perf_counter() - script_t0})
    emit({"kernels": [table[k] for k in kernel_registry()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
