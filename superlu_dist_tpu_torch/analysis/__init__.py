"""slulint for the port — project-native static analysis.

Port of the JAX package's ``analysis/`` package: its framework-neutral
engine and rules, with the two device rules retargeted at torch.

Rules:
  SLU101 collective-consistency   (rules_collective.py, interprocedural;
                                   TreeComm and ProcessGrid collectives)
  SLU102 capture purity           (rules_trace.py, CUDA-graph capture
                                   bodies through the call graph)
  SLU103 index-width discipline   (rules_index.py, flow-based)
  SLU104 env-knob registry        (rules_env.py, utils/options.py)
  SLU105 graph-cache-key hygiene  (rules_trace.py, interprocedural;
                                   runtime twin: numeric/stream.py's
                                   retrace sentinel)
  SLU107 graph-key shape diversity (rules_trace.py)
  SLU108 shared-mutable access    (rules_shared.py)
  SLU109 lock-order discipline    (rules_lockorder.py; runtime twin
                                   utils/lockwatch.py under
                                   SLU_TPU_VERIFY_LOCKS=1)
  SLU110 thread lifecycle         (rules_lifecycle.py)
  SLU111 dead argument copied     (rules_program.py, program walk)
  SLU112 baked tensors            (rules_program.py, program walk)
  SLU113 dispatch-loop host sync  (rules_program.py, device lattice)
  SLU114 collective lockstep      (rules_program.py, program walk and
                                   the ranks' digest exchange)
  SLU115 implicit downcast        (rules_precision.py, width lattice;
                                   and its program half)
  SLU116 unpinned GEMM tier       (rules_precision.py, source and
                                   program halves)
  SLU118 tolerance literals       (rules_precision.py, lexical)
  SLU119 implicit replication     (rules_sharding.py, program walk)
  SLU121 peak memory              (rules_sharding.py, program walk)
  SLU122 dispatch-loop copies     (rules_sharding.py, device lattice)

The program rules run over recorded programs (program.py: each program
run once on fake tensors under a recording dispatch mode) when the
runtime audits are on (utils/programaudit.py); in a source scan they
are catalog entries with nothing to check.

SLU102/SLU105/SLU107 are the JAX package's jit rules moved from jitted
bodies and jit cache keys to CUDA-graph capture bodies and graph-cache
keys.  Not ported: SLU117 (df64 pair components — the port runs df64 as
float64) and SLU120 (the JAX package's mesh-axis registry; the grid
keeps ``parallel/grid.AXES``).

Engine: every scan first builds a package-wide call graph
(callgraph.py) and per-function dataflow summaries over the
{i32, rank, env, device, f64/f32} taint lattice (dataflow.py); rules
consume both.  Scan results are cached content-hash-keyed (cache.py,
.slulint-torch-cache.json) so an unchanged tree rescans sub-second; the
CLI emits text, JSON or SARIF 2.1.0 (sarif.py).  Nothing here imports
torch except SLU104's registry read.

CLI: ``python -m superlu_dist_tpu_torch.analysis [paths]`` (default: the
package, chip_smoke.py and the port's scripts).
"""

from superlu_dist_tpu_torch.analysis.core import (Finding, Rule, analyze_paths,
                                                  analyze_source,
                                                  analyze_sources,
                                                  default_rules, read_sources)

__all__ = ["Finding", "Rule", "analyze_paths", "analyze_source",
           "analyze_sources", "default_rules", "read_sources"]
