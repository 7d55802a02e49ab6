"""The paper's function-centric parallelization layer, on torch.

Counterpart of ``repro.core``; the generic machinery mirrors the paper's
functions one-to-one:

=======================================  ================================================
Paper (Python + MPI)                     This package (torch)
=======================================  ================================================
``solve_problem``                        :func:`repro_torch.core.functional.solve_problem`
``parallel_solve_problem``               :func:`repro_torch.core.functional.parallel_solve_problem`
``simple_partitioning``                  :func:`repro_torch.core.partition.simple_partitioning`
``get_subproblem_input_args``            :func:`repro_torch.core.partition.get_subproblem_input_args`
``collect_subproblem_output_args``       :func:`repro_torch.core.collect.collect_subproblem_output_args`
``time_integration``                     :func:`repro_torch.core.time_integration.time_integration`
``parallel_time_integration``            :func:`repro_torch.core.time_integration.parallel_time_integration`
``dynamic_load_balancing``               :func:`repro_torch.core.load_balance.dynamic_load_balancing`
``find_optimal_workload``                :func:`repro_torch.core.load_balance.find_optimal_workload`
``redistribute_work``                    :func:`repro_torch.core.load_balance.redistribute_work`
``additive_Schwarz_iterations``          :func:`repro_torch.core.schwarz.additive_schwarz_iterations`
``simple_convergence_test``              :func:`repro_torch.core.schwarz.simple_convergence_test`
send/recv/all_gather function arguments  :class:`repro_torch.core.comm.Comm` (``torch.distributed``)
=======================================  ================================================

All four tiers are implementations of one
:class:`repro_torch.core.runtime.Executor` protocol — ``SerialExecutor`` /
``VmapExecutor`` / ``MeshExecutor`` / ``ThreadFarmExecutor`` — sharing the
paper's ``(initialize, func, finalize)`` contract; the functions above are
thin wrappers kept for the paper-faithful spelling.
"""
from repro_torch.core.comm import Comm, Mesh, make_mesh
from repro_torch.core.functional import (solve_problem, parallel_solve_problem,
                                         vmap_solve_problem, host_task_farm)
from repro_torch.core.runtime import (Executor, MeshExecutor, SerialExecutor,
                                      ThreadFarmExecutor, VmapExecutor,
                                      make_executor, straggler_deadline)
from repro_torch.core.partition import (simple_partitioning,
                                        get_subproblem_input_args,
                                        pad_to_multiple)
from repro_torch.core.collect import collect_subproblem_output_args
from repro_torch.core.time_integration import (time_integration,
                                               parallel_time_integration)
from repro_torch.core.load_balance import (
    find_optimal_workload, redistribute_work, dynamic_load_balancing,
    balanced_counts)
from repro_torch.core.schwarz import (additive_schwarz_iterations,
                                      simple_convergence_test, halo_exchange)

__all__ = [
    "Comm", "Mesh", "make_mesh", "solve_problem", "parallel_solve_problem",
    "vmap_solve_problem",
    "host_task_farm", "Executor", "SerialExecutor", "VmapExecutor", "MeshExecutor",
    "ThreadFarmExecutor", "make_executor", "straggler_deadline",
    "simple_partitioning", "get_subproblem_input_args", "pad_to_multiple",
    "collect_subproblem_output_args", "time_integration", "parallel_time_integration",
    "find_optimal_workload", "redistribute_work", "dynamic_load_balancing",
    "balanced_counts", "additive_schwarz_iterations", "simple_convergence_test",
    "halo_exchange",
]
