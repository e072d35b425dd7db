"""K1's and K4's shared-memory plan (ops/fused_edge.py ``smem_layout``)
against the kernels' headers (csrc/edge.cuh on csrc/decoder.cuh), on the
CPU: the constants equal the headers', the plan fits every latent width and
mode the wrapper takes, and it refuses the widths it does not take. On the
card, tests/test_torch_cuda.py holds the plan against the kernels' own
``gc_edge_layout``.
"""

import pathlib
import re

import pytest

from graphcast_tpu_torch.ops import fused_edge

_CSRC = (pathlib.Path(__file__).resolve().parents[1] / "graphcast_tpu_torch"
         / "csrc")


def _kernel_constants():
  """The ``constexpr int`` constants of csrc/decoder.cuh and csrc/edge.cuh,
  evaluated in order (sums and products of integers and earlier constants),
  and the count of K4's column sums from its enum."""
  consts = {}
  for name in ("decoder.cuh", "edge.cuh"):
    text = (_CSRC / name).read_text()
    for key, expr in re.findall(r"constexpr int (k(?:Dec|Edge)\w+) = ([^;]+);",
                                text):
      consts[key] = eval(expr, {"__builtins__": {}}, dict(consts))  # noqa
  text = (_CSRC / "fused_edge_bwd.cu").read_text()
  enum = re.search(r"enum \{ (kSScale[^}]*)\}", text).group(1)
  names = [n.strip() for n in enum.split(",")]
  consts["kEdgeSumsEmbed"] = names.index("kEdgeSumsEmbed")
  consts["kEdgeSums"] = names.index(
      re.search(r"constexpr int kEdgeSums = (\w+);", text).group(1))
  consts["kSB0"] = names.index("kSB0")
  return consts


def test_layout_constants_match_kernels():
  k = _kernel_constants()
  assert (k["kDecWidth"], k["kEdgeRows"], k["kEdgeCluster"], k["kDecBox"],
          k["kDecSmemLimit"], k["kEdgeMaxStages"], k["kDecAlign"],
          k["kDecExchange"], k["kEdgeIdx"], k["kEdgeSlots"]) == (
              fused_edge.WIDTH, fused_edge.ROWS, fused_edge.CLUSTER,
              fused_edge.BOX, fused_edge.SMEM_LIMIT, fused_edge.MAX_STAGES,
              fused_edge.ALIGN, fused_edge.EXCHANGE, fused_edge.IDX,
              fused_edge.SLOTS)
  assert k["kEdgeWork"] == fused_edge.BWD_WORK
  assert (k["kEdgeSums"], k["kSB0"], k["kEdgeSumsEmbed"]) == (
      fused_edge.BWD_SUMS["processor"], fused_edge.BWD_SUMS["encoder"],
      fused_edge.BWD_SUMS["embed"])
  # Each weight byte fetched from L2 serves at least 128 edge rows, and a
  # tile is one wgmma M.
  assert k["kEdgeRows"] * k["kEdgeCluster"] >= 128
  assert k["kEdgeRows"] == 64


@pytest.mark.parametrize("mode", ["forward", "forward_write_edges",
                                  "backward", "backward_embed"])
@pytest.mark.parametrize("C", [128, 256, 384, 512])
def test_smem_layout_fits_every_width_the_wrapper_takes(C, mode):
  """The block plan fits a block's 232,448 bytes at every latent width the
  wrapper accepts (each width in the layout of WIDTH), A (and K1's E tile
  where it writes e') on 1024-byte boundaries and wide enough for a
  WIDTH-wide operand, a ring of at least 8 boxes, room for every
  column-sum kind of the mode and kEdgeSlots of per-warp parts."""
  W = fused_edge.WIDTH
  backward = mode.startswith("backward")
  embed = mode == "backward_embed"
  write = mode == "forward_write_edges"
  lay = fused_edge.smem_layout(C, backward=backward, embed=embed,
                               write_edges=write)
  assert lay["total"] <= fused_edge.SMEM_LIMIT, lay
  assert lay["stages"] >= 8, lay
  assert lay["e"] - lay["a"] == 64 * W * 2
  assert lay["ring"] - lay["e"] == (64 * W * 2 if write else 0)
  assert lay["exchange"] - lay["ring"] == lay["stages"] * fused_edge.BOX
  for key in ("a", "e", "ring"):
    assert lay[key] % 1024 == 0, key
  assert lay["sums"] - lay["idx"] == fused_edge.ROWS * 4
  kinds = fused_edge.BWD_SUMS["embed" if embed else "processor"]
  assert lay["colred"] - lay["sums"] == (4 * kinds * W if backward else 0)
  assert lay["bars"] - lay["colred"] == (
      fused_edge.SLOTS * 4 * W * 4 if backward else 0)
  order = [lay[k] for k in ("a", "ring", "exchange", "idx", "sums", "colred",
                            "bars")]
  assert order == sorted(order)
  assert lay["bars"] % 8 == 0
  assert lay["total"] == (lay["bars"] + (2 * fused_edge.MAX_STAGES + 1) * 8
                          + fused_edge.ALIGN)
  # Deeper than the decoder's ring where K1 and K4 hold one tile, not two.
  from graphcast_tpu_torch.ops import fused_decoder
  dec = fused_decoder.smem_layout(C, 227)["stages"]
  assert lay["stages"] >= dec if write else lay["stages"] > dec


@pytest.mark.parametrize("C", [0, 64, 200, 640])
def test_smem_layout_refuses_widths_the_kernels_do_not_take(C):
  for backward in (False, True):
    with pytest.raises(ValueError):
      fused_edge.smem_layout(C, backward=backward)
  with pytest.raises(ValueError):
    fused_edge.smem_layout(512, backward=True, write_edges=True)


@pytest.mark.parametrize("staged", [False, True])
def test_pipelined_layout_matches_kernel_and_fits(staged):
  """K1p's plan (ops/fused_edge.py pipelined_smem_layout): K1's plan with
  the edge tile E (a ring as deep as K1's in the modes that write e') or,
  in encoder mode, the staged sender rows in its place (1024-aligned ring
  after it, at least as deep), two receiver buffers and an mbarrier,
  within a block's shared memory; the epilogue warps and the consumers
  fill the block's threads (the headers' constants)."""
  k = _kernel_constants()
  lay = fused_edge.pipelined_smem_layout(staged)
  k1 = fused_edge.smem_layout(fused_edge.WIDTH, write_edges=True)
  assert k["kEdgeStageStride"] == fused_edge.STAGE_STRIDE
  assert fused_edge.STAGE_STRIDE % 16 == 0
  assert (fused_edge.STAGE_STRIDE // 4) % 32 == 4  # 8 rows, 8 bank groups
  assert lay["ring"] % 1024 == 0 and lay["sums"] % 8 == 0
  if staged:
    assert lay["ring"] == k1["e"] + fused_edge.ROWS * fused_edge.STAGE_STRIDE
    assert lay["stages"] == k1["stages"]
  else:
    assert {n: lay[n] for n in ("a", "e", "ring", "stages", "exchange",
                                "idx")} == {
        n: k1[n] for n in ("a", "e", "ring", "stages", "exchange", "idx")}
  assert lay["sums"] == lay["idx"] + 2 * fused_edge.IDX
  assert lay["bars"] == lay["sums"] + 16
  assert lay["total"] <= fused_edge.SMEM_LIMIT
  assert lay["stages"] >= 8
  assert k["kEdgePipeSync"] == k["kDecConsumers"] + k["kEdgeWalkers"]
  assert k["kEdgeWalkers"] == 3 * 32  # the producer warpgroup's last 3
  assert k["kEdgeStageSync"] == k["kDecConsumers"] + 32
  bars = {k["kEdgeBarReady"], k["kEdgeBarFree"], k["kEdgeBarStaged"]}
  assert len(bars) == 3 and all(1 < b < 16 for b in bars)
