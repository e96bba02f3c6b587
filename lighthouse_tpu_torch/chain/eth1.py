"""Eth1 layer: deposit-contract cache (incremental merkle tree + proofs)
and eth1-data voting.

Parity surface: lighthouse/beacon_node/eth1/src/ (deposit log cache,
block cache feeding eth1-data votes) and beacon_chain/src/eth1_chain.rs
(vote selection). The deposit tree is the standard depth-32 incremental
merkle tree of the deposit contract, with length mixed in for the SSZ
List[DepositData] root — proofs from it feed process_deposit's
is_valid_merkle_branch (state_transition/block.py).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

DEPOSIT_TREE_DEPTH = 32


def _hash(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


class DepositTree:
    """Incremental merkle tree over deposit-data roots with proof support.

    Keeps all leaves (the cache stores every log anyway, eth1/src/
    deposit_cache.rs) so historical proofs at any deposit_count work —
    that is what blocks need: a proof against eth1_data.deposit_root which
    commits to deposit_count leaves."""

    def __init__(self):
        self.leaves: list[bytes] = []
        self._zeros = [b"\x00" * 32]
        for _ in range(DEPOSIT_TREE_DEPTH):
            self._zeros.append(_hash(self._zeros[-1], self._zeros[-1]))

    def push(self, deposit_data_root: bytes) -> None:
        self.leaves.append(deposit_data_root)

    def __len__(self):
        return len(self.leaves)

    def _root_at(self, count: int) -> bytes:
        """Root of the depth-32 tree over the first `count` leaves, with
        the deposit count mixed in (deposit contract get_deposit_root)."""
        node_layer = list(self.leaves[:count])
        for d in range(DEPOSIT_TREE_DEPTH):
            nxt = []
            for i in range(0, len(node_layer), 2):
                left = node_layer[i]
                right = node_layer[i + 1] if i + 1 < len(node_layer) else self._zeros[d]
                nxt.append(_hash(left, right))
            node_layer = nxt or [self._zeros[d + 1]]
        return _hash(node_layer[0], count.to_bytes(32, "little"))

    def root(self, count: int | None = None) -> bytes:
        return self._root_at(len(self.leaves) if count is None else count)

    def proof(self, index: int, count: int | None = None) -> list[bytes]:
        """Branch for leaf `index` in the tree of the first `count` leaves,
        plus the mixed-in length leaf (DEPOSIT_TREE_DEPTH + 1 elements,
        matching Deposit.proof)."""
        count = len(self.leaves) if count is None else count
        assert index < count
        layer = list(self.leaves[:count])
        idx = index
        branch = []
        for d in range(DEPOSIT_TREE_DEPTH):
            sib = idx ^ 1
            if sib < len(layer):
                branch.append(layer[sib])
            else:
                branch.append(self._zeros[d])
            nxt = []
            for i in range(0, len(layer), 2):
                left = layer[i]
                right = layer[i + 1] if i + 1 < len(layer) else self._zeros[d]
                nxt.append(_hash(left, right))
            layer = nxt or [self._zeros[d + 1]]
            idx //= 2
        branch.append(count.to_bytes(32, "little"))
        return branch


@dataclass
class Eth1Block:
    number: int
    hash: bytes
    timestamp: int
    deposit_root: bytes
    deposit_count: int


@dataclass
class Eth1Cache:
    """Block + deposit caches driving eth1-data votes (service.rs)."""

    tree: DepositTree = field(default_factory=DepositTree)
    blocks: list[Eth1Block] = field(default_factory=list)
    deposits: list[object] = field(default_factory=list)   # DepositData values

    def add_deposit(self, deposit_data, types) -> None:
        self.deposits.append(deposit_data)
        self.tree.push(types.DepositData.hash_tree_root(deposit_data))

    def add_block(self, block: Eth1Block) -> None:
        self.blocks.append(block)

    def deposits_for_block_inclusion(self, state, spec, types, eth1_data=None,
                                     fork=None):
        """Deposits the next block must include (eth1_deposit_index ..
        eth1_data.deposit_count), with proofs against `eth1_data` —
        pass the POST-vote eth1_data when the block's own vote will flip it
        (process_eth1_data runs before process_operations). Electra caps the
        legacy bridge at deposit_requests_start_index (EIP-6110)."""
        ed = eth1_data if eth1_data is not None else state.eth1_data
        start = state.eth1_deposit_index
        limit = ed.deposit_count
        from ..types.spec import ForkName

        if fork is not None and fork >= ForkName.electra:
            limit = min(limit, state.deposit_requests_start_index)
            if start >= limit:
                return []
        count = min(limit - start, spec.preset.MAX_DEPOSITS)
        out = []
        for i in range(start, start + count):
            proof = self.tree.proof(i, count=ed.deposit_count)
            out.append(types.Deposit.make(proof=proof, data=self.deposits[i]))
        return out

    def eth1_vote(self, state, spec, types):
        """Pick an eth1-data vote (eth1_chain.rs voting: follow-distance
        block in the voting period; falls back to the current vote)."""
        period_start = _voting_period_start_time(state, spec)
        follow_secs = 2048 * 14  # ETH1_FOLLOW_DISTANCE * seconds per eth1 block
        candidates = [
            b for b in self.blocks if b.timestamp + follow_secs <= period_start
        ]
        if not candidates:
            return state.eth1_data
        best = max(candidates, key=lambda b: b.number)
        if best.deposit_count < state.eth1_data.deposit_count:
            return state.eth1_data  # never roll back deposits
        return types.Eth1Data.make(
            deposit_root=best.deposit_root,
            deposit_count=best.deposit_count,
            block_hash=best.hash,
        )


class Eth1Service:
    """Deposit-log scraper service (eth1/src/service.rs analog): polls an
    eth1 JSON-RPC endpoint for DepositEvent logs from the deposit contract
    and new block headers, feeding the Eth1Cache + DepositTree that back
    eth1-data voting and deposit inclusion. The endpoint is duck-typed
    (`eth_getLogs`/`eth_blockNumber`/`eth_getBlockByNumber` via .call) so
    the mock EL's JSON-RPC double and a real HTTP client both slot in."""

    DEPOSIT_EVENT_TOPIC = bytes.fromhex(
        "649bbc62d0e31342afea4e5cd82d4049e7e1ee912fc0889aa790803be39038c5"
    )

    def __init__(self, rpc, spec, types, cache: "Eth1Cache | None" = None,
                 follow_distance: int = 0, batch_blocks: int = 1000):
        self.rpc = rpc
        self.spec = spec
        self.types = types
        self.cache = cache or Eth1Cache()
        self.follow_distance = follow_distance
        self.batch_blocks = batch_blocks
        self.last_processed_block = -1
        self.errors = 0

    @staticmethod
    def decode_deposit_log(data: bytes):
        """ABI-decode a DepositEvent log payload: five dynamic bytes fields
        (pubkey, withdrawal_credentials, amount[le64], signature, index)."""
        def dyn(offset_slot: int) -> bytes:
            off = int.from_bytes(data[offset_slot * 32 : offset_slot * 32 + 32], "big")
            ln = int.from_bytes(data[off : off + 32], "big")
            return data[off + 32 : off + 32 + ln]

        pubkey = dyn(0)
        wc = dyn(1)
        amount = int.from_bytes(dyn(2), "little")
        signature = dyn(3)
        index = int.from_bytes(dyn(4), "little")
        return pubkey, wc, amount, signature, index

    def poll_once(self) -> int:
        """One scrape round: fetch logs/blocks up to head-follow_distance.
        Returns deposits ingested; errors are counted, never raised (the
        reference's service loop survives flaky endpoints)."""
        try:
            head = int(self.rpc.call("eth_blockNumber", []), 16)
            target = head - self.follow_distance
            if target <= self.last_processed_block:
                return 0
            frm = self.last_processed_block + 1
            to = min(target, frm + self.batch_blocks - 1)
            logs = self.rpc.call(
                "eth_getLogs",
                [
                    {
                        "fromBlock": hex(frm),
                        "toBlock": hex(to),
                        "address": "0x" + self.spec.deposit_contract_address.hex(),
                        "topics": ["0x" + self.DEPOSIT_EVENT_TOPIC.hex()],
                    }
                ],
            )
            decoded = [
                self.decode_deposit_log(bytes.fromhex(lg["data"][2:])) for lg in logs
            ]
            # A missing/duplicated/reordered log would silently corrupt the
            # deposit tree root and every later proof: each event's own index
            # MUST be the next tree leaf (service.rs errors on non-consecutive
            # deposit logs). A retried range may legitimately re-serve an
            # already-ingested prefix (a prior round ingested, then failed
            # before advancing last_processed_block) — skip idx < base, then
            # require the remainder to be exactly consecutive from base.
            # Validate BEFORE ingesting so a bad range is retried intact.
            base = len(self.cache.tree)
            fresh = [d for d in decoded if d[4] >= base]
            if any(idx != base + i for i, (_, _, _, _, idx) in enumerate(fresh)):
                self.errors += 1
                return 0
            n = 0
            for pk, wc, amount, sig, _idx in fresh:
                dd = self.types.DepositData.make(
                    pubkey=pk, withdrawal_credentials=wc, amount=amount, signature=sig
                )
                self.cache.add_deposit(dd, self.types)
                n += 1
            blk = self.rpc.call("eth_getBlockByNumber", [hex(to), False])
            if blk is not None:
                self.cache.add_block(
                    Eth1Block(
                        number=to,
                        hash=bytes.fromhex(blk["hash"][2:]),
                        timestamp=int(blk["timestamp"], 16),
                        deposit_count=len(self.cache.tree),
                        deposit_root=self.cache.tree.root(),
                    )
                )
            self.last_processed_block = to
            return n
        except Exception:  # noqa: BLE001 — endpoint flakiness must not kill the node
            self.errors += 1
            return 0


class MockEth1Rpc:
    """JSON-RPC double serving deposit logs (mock eth1 endpoint for tests
    and the simulator: eth1/src/service tests use the same shape)."""

    def __init__(self, deposit_contract_address: bytes):
        self.address = deposit_contract_address
        self.blocks: list[dict] = [
            {"hash": "0x" + "00" * 32, "timestamp": hex(1_600_000_000), "number": "0x0"}
        ]
        self.logs: list[dict] = []

    def add_block(self, timestamp: int) -> int:
        import hashlib

        n = len(self.blocks)
        h = hashlib.sha256(f"eth1-{n}".encode()).digest()
        self.blocks.append(
            {"hash": "0x" + h.hex(), "timestamp": hex(timestamp), "number": hex(n)}
        )
        return n

    def add_deposit_log(self, block_number: int, pubkey: bytes, wc: bytes,
                        amount_gwei: int, signature: bytes, index: int) -> None:
        def dyn_tuple(fields: list[bytes]) -> bytes:
            head = b""
            tail = b""
            base = 32 * len(fields)
            for f in fields:
                head += (base + len(tail)).to_bytes(32, "big")
                tail += len(f).to_bytes(32, "big") + f + b"\x00" * ((32 - len(f) % 32) % 32)
            return head + tail

        data = dyn_tuple(
            [
                pubkey,
                wc,
                amount_gwei.to_bytes(8, "little"),
                signature,
                index.to_bytes(8, "little"),
            ]
        )
        self.logs.append(
            {
                "blockNumber": hex(block_number),
                "address": "0x" + self.address.hex(),
                "topics": ["0x" + Eth1Service.DEPOSIT_EVENT_TOPIC.hex()],
                "data": "0x" + data.hex(),
            }
        )

    def call(self, method: str, params: list):
        if method == "eth_blockNumber":
            return hex(len(self.blocks) - 1)
        if method == "eth_getBlockByNumber":
            n = int(params[0], 16)
            return self.blocks[n] if n < len(self.blocks) else None
        if method == "eth_getLogs":
            f = params[0]
            frm, to = int(f["fromBlock"], 16), int(f["toBlock"], 16)
            return [
                lg for lg in self.logs if frm <= int(lg["blockNumber"], 16) <= to
            ]
        raise ValueError(f"unknown method {method}")


def _voting_period_start_time(state, spec) -> int:
    period_slots = spec.preset.EPOCHS_PER_ETH1_VOTING_PERIOD * spec.preset.SLOTS_PER_EPOCH
    start_slot = state.slot - state.slot % period_slots
    return state.genesis_time + start_slot * spec.seconds_per_slot
