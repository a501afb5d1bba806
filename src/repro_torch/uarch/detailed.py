"""Detailed simulator — the O3CPU analogue.

Timing model (simplified out-of-order superscalar, faithful to the observable
behaviour §4.1 relies on):

* Fetch: `fetch_width` records per cycle; I-cache (L1I -> L2 -> mem) misses
  stall the front end; every fetched record (real, squashed, nop) gets a
  `fetch_clock`, and `fetch_lat` is the delta to the previously fetched record
  — exactly the quantity the paper re-attributes during dataset construction.
* Speculation: conditional branches are predicted (Local/BiMode/Tournament/
  TAGE); on a mispredict the wrong path is fetched from static code and
  emitted as KIND_SQUASHED records until the branch resolves, then the front
  end restarts — the next correct instruction's fetch_clock absorbs the full
  misprediction penalty (paper Figure 2).
* Stalls: when the ROB is full, a single KIND_NOP bubble record is emitted
  and fetch waits for the oldest in-flight instruction to retire (in-order
  retirement).
* Execution: issue waits on source-register readiness; exec latency = opcode
  class latency + data-hierarchy latency (L1/L2/mem + TLB) for loads.
  retire_clock = fetch_clock + (complete - fetch_clock) so the total-cycle
  invariant `max(retire_clock)` is preserved exactly by the §4.1 alignment.

Returns the detailed trace (DET_TRACE_DTYPE) including squashed/nop records
interleaved in fetch order, plus a summary dict of aggregate metrics.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Tuple

import numpy as np

from .branch import make_predictor
from .cache import LINE_BYTES, Cache, TLB
from .config import MicroArchConfig
from .isa import (
    DET_TRACE_DTYPE,
    DLEVEL_L1,
    DLEVEL_L2,
    DLEVEL_MEM,
    DLEVEL_NONE,
    EXEC_LATENCY_ARR,
    KIND_NOP,
    KIND_REAL,
    KIND_SQUASHED,
    Op,
)
from .program import PC_STRIDE, Program

__all__ = ["run_detailed", "summarize_detailed"]

_BRANCH_SET = {int(Op.BEQ), int(Op.BNE), int(Op.BLT), int(Op.BGE)}
_MAX_WRONG_PATH = 48  # cap on squashed records per mispredict


def run_detailed(
    program: Program,
    func_trace: np.ndarray,
    cfg: MicroArchConfig,
) -> Tuple[np.ndarray, Dict]:
    code = program.code
    n_static = len(code)
    ops_s = np.array([int(i.op) for i in code], dtype=np.int16)
    dsts_s = np.array([i.dst for i in code], dtype=np.int8)
    src1_s = np.array([i.src1 for i in code], dtype=np.int8)
    src2_s = np.array([i.src2 for i in code], dtype=np.int8)
    tgt_s = np.array([i.target for i in code], dtype=np.int64)

    bp = make_predictor(cfg.branch_predictor)
    l1d = Cache(cfg.l1d_size, cfg.l1d_assoc)
    l1i = Cache(cfg.l1i_size, cfg.l1i_assoc)
    l2 = Cache(cfg.l2_size, cfg.l2_assoc)
    tlb = TLB()

    n = len(func_trace)
    # Worst case: every instruction is a mispredicted branch... be generous
    # but bounded; grow if needed.
    cap = int(n * 1.6) + 64
    out = np.zeros(cap, dtype=DET_TRACE_DTYPE)

    f_pc = func_trace["pc"]
    f_op = func_trace["opcode"]
    f_dst = func_trace["dst"]
    f_s1 = func_trace["src1"]
    f_s2 = func_trace["src2"]
    f_isbr = func_trace["is_branch"]
    f_taken = func_trace["taken"]
    f_ismem = func_trace["is_mem"]
    f_isst = func_trace["is_store"]
    f_addr = func_trace["addr"]

    reg_ready = np.zeros(32, dtype=np.int64)
    rob = deque()  # in-order completion times of in-flight instructions
    rob_size = cfg.rob_size
    fetch_width = cfg.fetch_width

    clock = 0          # current fetch cycle
    slot = 0           # fetch slot within current cycle
    last_fetch_clock = 0
    last_line = -1     # last fetched I-cache line
    w = 0              # write cursor into `out`
    n_squashed = 0
    n_nops = 0
    n_mispred = 0
    n_branches = 0
    inorder_complete = 0  # completion time of the most recent in-flight instr

    exec_lat_arr = EXEC_LATENCY_ARR
    l1_lat, l2_lat, mem_lat = cfg.l1_extra_lat, cfg.l2_extra_lat, cfg.mem_extra_lat
    tlb_lat = cfg.tlb_miss_lat
    ic_l2, ic_mem = cfg.icache_l2_lat, cfg.icache_mem_lat

    def fetch_advance():
        """Consume one fetch slot; returns the clock the record is fetched at."""
        nonlocal clock, slot
        c = clock
        slot += 1
        if slot >= fetch_width:
            slot = 0
            clock += 1
        return c

    def icache_access(pc_bytes: int) -> Tuple[int, bool]:
        """Front-end I-fetch; returns (extra stall cycles, missed)."""
        nonlocal last_line
        line = pc_bytes // LINE_BYTES
        if line == last_line:
            return 0, False
        last_line = line
        if l1i.access(pc_bytes):
            return 0, False
        if l2.access(pc_bytes):
            return ic_l2, True
        return ic_mem, True

    def ensure_cap(extra: int):
        nonlocal out, cap
        if w + extra >= cap:
            new_cap = int(cap * 1.5) + extra + 64
            new = np.zeros(new_cap, dtype=DET_TRACE_DTYPE)
            new[:w] = out[:w]
            out = new
            cap = new_cap

    for i in range(n):
        ensure_cap(2 + _MAX_WRONG_PATH)
        op = int(f_op[i])
        pc_bytes = int(f_pc[i])
        static_idx = pc_bytes // PC_STRIDE

        # ---- ROB occupancy: stall fetch if full -----------------------
        while rob and rob[0] <= clock:
            rob.popleft()
        if len(rob) >= rob_size:
            # Emit one stall bubble; fetch resumes when the head retires.
            head = rob.popleft()
            r = out[w]
            r["pc"] = pc_bytes
            r["opcode"] = int(Op.NOP)
            r["kind"] = KIND_NOP
            fc = fetch_advance()
            r["fetch_clock"] = fc
            r["fetch_lat"] = fc - last_fetch_clock
            r["exec_lat"] = 1
            r["retire_clock"] = fc + 1
            last_fetch_clock = fc
            w += 1
            n_nops += 1
            if head > clock:
                clock = int(head)
                slot = 0
            while rob and rob[0] <= clock:
                rob.popleft()

        # ---- front-end: I-cache ---------------------------------------
        ic_stall, ic_miss = icache_access(pc_bytes)
        if ic_stall:
            clock += ic_stall
            slot = 0

        fc = fetch_advance()

        # ---- execute ---------------------------------------------------
        s1 = int(f_s1[i])
        s2 = int(f_s2[i])
        issue = max(fc + 1, reg_ready[s1], reg_ready[s2])
        lat = int(exec_lat_arr[op])
        dlevel = DLEVEL_NONE
        tlb_miss = False
        if f_ismem[i]:
            addr = int(f_addr[i])
            if not tlb.access(addr):
                tlb_miss = True
                lat += tlb_lat
            if l1d.access(addr):
                dlevel = DLEVEL_L1
                lat += l1_lat if not f_isst[i] else 0
            elif l2.access(addr):
                dlevel = DLEVEL_L2
                lat += l2_lat if not f_isst[i] else 0
            else:
                dlevel = DLEVEL_MEM
                lat += mem_lat if not f_isst[i] else 0
        complete = issue + lat
        dst = int(f_dst[i])
        if dst:
            reg_ready[dst] = complete
        # In-order retirement: completion times are monotone in the ROB.
        inorder_complete = max(inorder_complete, complete)
        rob.append(inorder_complete)

        # ---- branch prediction / speculation ---------------------------
        mispred = False
        if op in _BRANCH_SET:
            n_branches += 1
            pred = bp.predict(pc_bytes)
            actual = bool(f_taken[i])
            bp.update(pc_bytes, actual)
            if pred != actual:
                mispred = True
                n_mispred += 1

        r = out[w]
        r["pc"] = pc_bytes
        r["opcode"] = op
        r["dst"] = dst
        r["src1"] = s1
        r["src2"] = s2
        r["is_branch"] = f_isbr[i]
        r["taken"] = f_taken[i]
        r["is_mem"] = f_ismem[i]
        r["is_store"] = f_isst[i]
        r["addr"] = f_addr[i]
        r["kind"] = KIND_REAL
        r["fetch_clock"] = fc
        r["fetch_lat"] = fc - last_fetch_clock
        r["exec_lat"] = complete - fc
        r["retire_clock"] = complete
        r["mispred"] = mispred
        r["dlevel"] = dlevel
        r["icache_miss"] = ic_miss
        r["tlb_miss"] = tlb_miss
        last_fetch_clock = fc
        w += 1

        if mispred:
            # Fetch the wrong path until the branch resolves at `complete`.
            actual = bool(f_taken[i])
            wrong_pc = int(tgt_s[static_idx]) if not actual else static_idx + 1
            resolve = complete
            nsq = 0
            while clock < resolve and nsq < _MAX_WRONG_PATH:
                if wrong_pc >= n_static:
                    wrong_pc = program.entry
                sop = int(ops_s[wrong_pc])
                sq = out[w]
                sq["pc"] = wrong_pc * PC_STRIDE
                sq["opcode"] = sop
                sq["dst"] = dsts_s[wrong_pc]
                sq["src1"] = src1_s[wrong_pc]
                sq["src2"] = src2_s[wrong_pc]
                sq["kind"] = KIND_SQUASHED
                sfc = fetch_advance()
                sq["fetch_clock"] = sfc
                sq["fetch_lat"] = sfc - last_fetch_clock
                sq["exec_lat"] = 1
                sq["retire_clock"] = sfc + 1
                last_fetch_clock = sfc
                w += 1
                nsq += 1
                n_squashed += 1
                # Wrong-path control flow: follow unconditional jumps,
                # fall through conditional branches.
                if sop == int(Op.JMP):
                    wrong_pc = int(tgt_s[wrong_pc])
                else:
                    wrong_pc += 1
            # Squash + front-end restart.
            clock = max(clock, resolve) + cfg.mispredict_restart
            slot = 0

    out = out[:w]
    total_cycles = int(out["retire_clock"].max()) if w else 0
    real_mask = out["kind"] == KIND_REAL
    summary = {
        "uarch": cfg.name,
        "num_committed": int(real_mask.sum()),
        "num_squashed": n_squashed,
        "num_nops": n_nops,
        "num_branches": n_branches,
        "num_mispred": n_mispred,
        "total_cycles": total_cycles,
        "cpi": total_cycles / max(1, int(real_mask.sum())),
        "l1d_miss_rate": l1d.misses / max(1, l1d.hits + l1d.misses),
        "l2_miss_rate": l2.misses / max(1, l2.hits + l2.misses),
        "branch_mispred_rate": n_mispred / max(1, n_branches),
        "l1d_mpki": 1000.0 * l1d.misses / max(1, int(real_mask.sum())),
        "branch_mpki": 1000.0 * n_mispred / max(1, int(real_mask.sum())),
    }
    return out, summary


def summarize_detailed(det: np.ndarray) -> Dict:
    """Aggregate metrics straight from a detailed trace array."""
    real = det[det["kind"] == KIND_REAL]
    n = max(1, len(real))
    branches = real["is_branch"].sum()
    return {
        "num_committed": len(real),
        "total_cycles": int(det["retire_clock"].max()) if len(det) else 0,
        "cpi": float(det["retire_clock"].max()) / n if len(det) else 0.0,
        "branch_mpki": 1000.0 * float(real["mispred"].sum()) / n,
        "l1d_mpki": 1000.0 * float((real["dlevel"] >= DLEVEL_L2).sum()) / n,
        "branch_mispred_rate": float(real["mispred"].sum()) / max(1, int(branches)),
    }
