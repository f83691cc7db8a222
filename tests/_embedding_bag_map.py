"""The tests' model of how ``rt_embedding_bag`` (``csrc/embedding_bag.cu``)
routes a call and lays out the routed kernels' work.  The C entry alone
decides in the port; this copy lets ``test_torch_embedding_bag_map.py``
model the work map on the CPU and size the card tests' cases.  ``ROUTES``
writes the entry's choices out by hand: the map test holds :func:`plan`
to it, the card tests hold the entry to it.  It imports only the
standard library, so the card tests use it without JAX."""
from __future__ import annotations

from dataclasses import dataclass

GENERIC, WIDE, NARROW = "generic", "wide", "narrow"

# the constants of csrc/embedding_bag.cu that the map depends on
VEC_WARPS = 8          # kVecWarps: warps a block
WIDE_BYTES = 16        # kWideBytes: a wide lane's load
NARROW_MAX_BYTES = 64  # kNarrowMaxBytes: a narrow row (32 with 4-byte loads)
STAGE = 256            # kStage: (bag, slot) entries of a warp's staged chunk
# a lane's registers, at most: rows in flight in 32-bit words (kOneRawWords
# for bags of one, kRawWords for longer ones) and accumulators (kAccFloats
# wide, kNarrowAccFloats narrow)
ONE_RAW_WORDS, RAW_WORDS = 8, 16
ACC_FLOATS, NARROW_ACC_FLOATS = 16, 8

# The kernel the entry runs for bags of at least one slot into a 16-byte
# aligned output, by the table's type and its base's offset from a 16-byte
# boundary, at each of ROUTE_DIMS.
ROUTE_DIMS = (1, 10, 16, 64, 96, 128, 200, 256)
_W, _N, _G = WIDE, NARROW, GENERIC
ROUTES = {
    ("float32", 0): (_N, _N, _W, _W, _W, _W, _W, _W),
    ("float32", 8): (_N, _N, _N, _G, _G, _G, _G, _G),
    ("float32", 4): (_N, _G, _G, _G, _G, _G, _G, _G),
    ("float32", 2): (_G, _G, _G, _G, _G, _G, _G, _G),
    ("bfloat16", 0): (_G, _N, _W, _W, _W, _W, _W, _W),
    ("bfloat16", 8): (_G, _N, _N, _G, _G, _G, _G, _G),
    ("bfloat16", 4): (_G, _N, _N, _G, _G, _G, _G, _G),
    ("bfloat16", 2): (_G, _G, _G, _G, _G, _G, _G, _G),
}


def route(table_type: str, table_offset: int, dim: int) -> str:
    """``ROUTES``' kernel for a table of ``table_type`` whose base lies
    ``table_offset`` bytes past a 16-byte boundary."""
    return ROUTES[(table_type, table_offset % 16)][ROUTE_DIMS.index(dim)]


@dataclass(frozen=True)
class Plan:
    """One call's kernel and work map.  ``v``: bytes a load; ``r``: loads
    a row; ``tb``: bags a warp's tile; ``j``: slots of a staged chunk.
    ``s``: slots of a bag loaded before their FMAs.  Wide: ``g`` lanes a
    row, each holding ``k`` of its loads (words ``sub + k g``), ``u`` bags
    a lane group sums at once.  Narrow (``g = u = 1``): the tile's rows are
    one span of ``tb r`` words, ``k`` of them a lane (``lane + 32 i``)."""
    kernel: str
    v: int = 0
    r: int = 0
    g: int = 0
    k: int = 0
    u: int = 0
    s: int = 0
    j: int = 0
    tb: int = 0


def _pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def plan(dim: int, nnz: int, table_elt: int, table_addr: int = 0,
         out_addr: int = 0) -> Plan:
    """The kernel and work map of a call on a [rows, dim] table of
    ``table_elt``-byte elements at ``table_addr`` into an output at
    ``out_addr``, with bags of ``nnz`` slots."""
    rb = dim * table_elt
    v = 0
    if nnz >= 1 and out_addr % 16 == 0:
        if rb % WIDE_BYTES == 0 and table_addr % WIDE_BYTES == 0:
            v = WIDE_BYTES
        elif rb <= NARROW_MAX_BYTES and rb % 8 == 0 and table_addr % 8 == 0:
            v = 8
        elif (rb <= NARROW_MAX_BYTES // 2 and rb % 4 == 0
              and table_addr % 4 == 0):
            v = 4
    if not v:
        return Plan(GENERIC)
    r, el, w = rb // v, v // table_elt, v // 4
    if v == WIDE_BYTES:
        k = 2 if r > 32 else 1
        g = _pow2_at_least(-(-r // k))
        u, s = ((min(ACC_FLOATS // (k * el), ONE_RAW_WORDS // (k * w)), 1)
                if nnz == 1 else (1, min(8, RAW_WORDS // (k * w))))
        kernel, tb = WIDE, 32 // g * u
    else:
        k, s = ((min(4, NARROW_ACC_FLOATS // el, ONE_RAW_WORDS // w), 1)
                if nnz == 1 else (1, min(8, RAW_WORDS // w)))
        kernel, g, u, tb = NARROW, 1, 1, 32 * k // r
    j = 1
    while j < nnz and tb * 2 * j <= STAGE:
        j <<= 1
    return Plan(kernel, v, r, g, k, u, s, j, tb)
