"""K4's device ms a launch in the window: the device time of the resident
PCG solve's kernels (``solve_cluster_kernel``, ``solve_grid_kernel``) over
the launches the port's counters count inside ``ellk_soa.lm_optimize_soa``.
A launch runs CG steps to its tolerance, a number the host does not see, so
this is a time and not a share of a roofline."""

READS = ("device_trace", "spans:lm.pcg", "program_counter:kernel_launches")
KERNELS = ("solve_cluster_kernel", "solve_grid_kernel")


def read(rec):
    dev = rec.device_s(KERNELS)
    n = sum(c["launches"]["resident_solve"] for c in rec.spans.get("lm.pcg", []))
    return 1e3 * dev / n if dev > 0 and n else None
