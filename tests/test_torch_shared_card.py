"""The shared-card study and chip_smoke.py's shared_card phase, on the CPU.

graphcast_tpu_torch/tools/shared_card_study.py runs the port's kernels in
two processes that time-share one card; its cases, its copies of the
kernel sources and its runs need the card. Here: the study knows every
kernel of the port (the TPU kernels K1-K8 and the weight-gradient
reduction, in each mode the port runs) and refuses other names; its
patches of csrc/ (the flight recorder and the bisection's variants) still
find their anchors in the sources; the recorder's buffer decodes; the
shared_card phase comes right after build, launches each kernel for the
seconds the phase promises, and its collection of the processes' results
raises on a reported error and on outputs that differ from one process's
(fake processes' files); and the phase catches nothing.
"""

import ast
import ctypes
import inspect
import json
import pathlib
import sys
import textwrap

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from graphcast_tpu_torch.ops import fused_decoder, fused_edge  # noqa: E402
from graphcast_tpu_torch.tools import shared_card_study as study  # noqa: E402

CSRC = REPO / "graphcast_tpu_torch" / "csrc"

# Each TPU kernel of the repo (PERF.md's table) and the study's names for
# the modes the port runs it in.
TABLE = {"K1": ("k1", "k1enc", "k1emb"), "K1p": ("k1p", "k1penc"),
         "K2": ("k2", "k2emb"), "K3": ("k3",), "K4": ("k4", "k4enc"),
         "K5": ("k5", "k5emb"), "K6": ("k6",), "K7": ("k7k8",),
         "K8": ("k7k8",), "weight_grad": ("wgrad",)}


@pytest.mark.parametrize("kernel", sorted(TABLE))
def test_study_knows_every_kernel_of_the_table(kernel):
  for name in TABLE[kernel]:
    assert name in study.KERNELS


@pytest.mark.parametrize("name", ["k9", "K2", "fused_decoder", ""])
def test_study_refuses_an_unknown_kernel(name):
  with pytest.raises(ValueError, match="unknown kernel"):
    study.case(name)


def test_study_refuses_an_unknown_variant():
  with pytest.raises(ValueError, match="unknown variant"):
    study._library("k2", False)


@pytest.mark.parametrize("variant", study.VARIANTS)
def test_study_patches_find_their_anchors(variant):
  hopper = study._patch_hopper((CSRC / "hopper.cuh").read_text(), variant,
                               trap=False)
  ring = study._patch_ring((CSRC / "decoder.cuh").read_text(), variant)
  assert "flight_note(3, addr, parity" in hopper
  assert study.TIMEOUT_FAULT in hopper and "__trap();" not in hopper
  assert "gc_flight_register" in hopper
  assert "kFlightEmpty" in ring and "kFlightFull" in ring
  units = (sorted(p.name for p in CSRC.glob("*.cu")) if variant == "all"
           else ["fused_decoder.cu"])
  patched = {u: study._patch_units((CSRC / u).read_text(), u, variant)
             for u in units}
  k2 = patched["fused_decoder.cu"]
  assert "flight_done();" in k2
  expected = {
      "signed": (hopper, "(long long)(now - t0) > 10000000000ll"),
      "syncwarp": (ring, "(p / stages) & 1);\n    __syncwarp();"),
      "cluster1": (ring, "constexpr int kDecCluster = 1;"),
      "nomcast": (ring, "tma_load_2d(ring + s * kDecBox"),
      "even": (ring, "kDecMaxStages) & ~1;"),
      "odd": (ring, "kDecMaxStages) | 1;"),
      "noG": (k2, "a.gridp + (size_t)(v0 + r) * C + c"),
      "noagg": (k2, "prev[z] = make_float4"),
      "nostore": (k2, 'asm volatile("" ::"f"(acc[0]')}
  if variant in expected:
    text, needle = expected[variant]
    assert needle in text
  if variant == "cluster1":
    assert "if (kDecCluster > 1) cluster_sync();" in k2
  if variant == "nomcast":
    assert "tma_load_2d_multicast" not in ring.split("struct ClusterProducer")[
        1].split("};")[0]


def test_study_trap_build_keeps_the_trap():
  hopper = study._patch_hopper((CSRC / "hopper.cuh").read_text(), "all",
                               trap=True)
  assert "__trap();" in hopper and study.TIMEOUT_FAULT not in hopper


def _fake_flight():
  f = study.Flight.__new__(study.Flight)
  n = study.FLIGHT_BLOCKS * study.FLIGHT_ROLES * study.FLIGHT_WORDS
  f.words = (ctypes.c_uint64 * n)()
  return f


def _note(f, block, role, ns, pos, what, elapsed=0):
  i = (block * study.FLIGHT_ROLES + role) * study.FLIGHT_WORDS
  f.words[i:i + 4] = [ns, pos, what, elapsed % (1 << 64)]


def test_flight_record_lists_unfinished_blocks_and_timeouts():
  f = _fake_flight()
  assert f.unfinished() == ["flight: no notes"]
  t = 10 ** 12
  _note(f, 0, 0, t, ~0 % (1 << 64), 255 | (7 << 32))          # done
  _note(f, 1, 1, t + 5, 640, 1 | (3 << 8) | (9 << 32))        # full[3]
  _note(f, 2, 2, t - 10 ** 10, 64, 1)                         # stale
  _note(f, 1, 3, t + 6, 0x1234, 1 | (9 << 32) | (2 << 48), -5)
  lines = f.unfinished()
  assert len(lines) == 3, lines
  assert lines[0].startswith("flight: 1 roles done; wg0: 1 blocks 1-1 pos "
                             "640-640 waits full"), lines[0]
  assert "role=timeout" in lines[1] and "bar_smem=0x1234" in lines[1]
  # A wrapped unsigned subtraction: elapsed near 2^64, signed -5.
  assert f"elapsed_ns={(1 << 64) - 5}" in lines[1] and "signed=-5" in lines[1]
  assert "block=1 role=wg0" in lines[2] and "pos=640 waits=full" in lines[2]
  assert "stage=3" in lines[2] and "sm=9" in lines[2]


def test_shared_card_comes_right_after_build():
  assert chip_smoke.PHASES[:2] == ("build", "shared_card")
  assert chip_smoke.PHASES.count("shared_card") == 1
  assert "parallel" in chip_smoke.PHASES


def test_shared_card_plan_runs_every_promised_kernel_long_enough():
  plan = dict(chip_smoke.SHARED_CARD_PLAN)
  assert [k for k, _ in chip_smoke.SHARED_CARD_PLAN] == [
      "k2", "k5", "k1", "k4", "k6"]
  assert plan["k2"] >= 20 and plan["k5"] >= 20
  assert min(plan["k1"], plan["k4"], plan["k6"]) >= 10
  assert set(plan) <= set(study.KERNELS)
  assert chip_smoke.SHARED_CARD_WORLD == 2


def _fake_rank(out_dir, rank, outputs, errors=()):
  report = {"rank": rank, "errors": list(errors), "kernels": {
      k: {"calls": 3, "launches": 3, "host_s": 20.0, "device_s": 20.1}
      for k in outputs}}
  (out_dir / f"rank{rank}.json").write_text(json.dumps(report))
  torch.save(outputs, out_dir / f"rank{rank}.pt")


def _outputs(seed):
  gen = torch.Generator().manual_seed(seed)
  return {"k2": [torch.randn(5, 3, generator=gen).to(torch.bfloat16)],
          "k5": [torch.randn(4, generator=gen),
                 torch.randn(2, 2, generator=gen)]}


def test_collect_accepts_ranks_equal_to_one_process(tmp_path):
  want = _outputs(0)
  for r in range(2):
    _fake_rank(tmp_path, r, _outputs(0))
  reports = study.collect(str(tmp_path), 2, want)
  assert [r["rank"] for r in reports] == [0, 1]


def test_collect_raises_when_a_rank_reports_an_error(tmp_path):
  _fake_rank(tmp_path, 0, _outputs(0))
  _fake_rank(tmp_path, 1, _outputs(0), errors=["k2: 0 launches in 3 calls"])
  with pytest.raises(AssertionError, match="rank 1"):
    study.collect(str(tmp_path), 2, _outputs(0))


@pytest.mark.parametrize("change", ["value", "missing_tensor"])
def test_collect_raises_when_outputs_differ(tmp_path, change):
  _fake_rank(tmp_path, 0, _outputs(0))
  bad = _outputs(0)
  if change == "value":
    bad["k5"][1][1, 1] += 1e-3
  else:
    bad["k5"] = bad["k5"][:1]
  _fake_rank(tmp_path, 1, bad)
  with pytest.raises(AssertionError, match="k5's last outputs differ"):
    study.collect(str(tmp_path), 2, _outputs(0))


def test_collect_raises_when_a_rank_left_no_result(tmp_path):
  _fake_rank(tmp_path, 0, _outputs(0))
  with pytest.raises(FileNotFoundError):
    study.collect(str(tmp_path), 2, _outputs(0))


@pytest.mark.parametrize("fn", [chip_smoke.phase_shared_card, study.hammer,
                                study.reference, study.collect],
                         ids=lambda fn: fn.__name__)
def test_shared_card_phase_catches_nothing(fn):
  tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
  tries = [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
  assert not tries, f"{fn.__name__} catches an exception"
  # Nothing between the launches synchronises: one synchronize, after
  # every kernel of the plan.
  if fn is study.hammer:
    assert inspect.getsource(fn).count("synchronize()") == 1


@pytest.mark.parametrize("kernel,layout", [
    ("K2", lambda C: fused_decoder.smem_layout(C, 227)),
    ("K2 embed", lambda C: fused_decoder.smem_layout(C, 84, embed=True)),
    ("K5", lambda C: fused_decoder.smem_layout(C, 512, backward=True)),
    ("K5 embed", lambda C: fused_decoder.smem_layout(C, 512, embed=True,
                                                     backward=True)),
    ("K1", lambda C: fused_edge.smem_layout(C)),
    ("K1 e'", lambda C: fused_edge.smem_layout(C, write_edges=True)),
    ("K4", lambda C: fused_edge.smem_layout(C, backward=True)),
    ("K4 embed", lambda C: fused_edge.smem_layout(C, backward=True,
                                                  embed=True)),
    ("K1p", lambda C: fused_edge.pipelined_smem_layout()),
    ("K1p staged", lambda C: fused_edge.pipelined_smem_layout(True))])
def test_every_cluster_ring_is_even(kernel, layout):
  """Each cluster kernel's ring depth is even, so each stage belongs to one
  consumer warpgroup and every parity wait on its full barrier follows a
  wait on the phase before (csrc/decoder.cuh ClusterRing): the repair of
  the shared-card fault, in the layouts' mirrors."""
  for C in (128, 256, 384, 512):
    stages = layout(C)["stages"]
    assert stages % 2 == 0 and stages >= 6, (kernel, C, stages)
