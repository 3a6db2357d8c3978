"""K1-K3's share of their roofline in the window (%): the least time the
chip could take for the linearization and chi2 launches inside each
resident PCG solve (``ellk_soa.lm_optimize_soa``), counted by the port's
launch counters and bounded for that solve's live keyframes, landmarks and
edges (``flops.k1``-``k3``), over the device time of K1-K3's kernels in the
trace. K4 is left out: its CG steps a launch are not visible to the host,
so no bound counts its work; ``k4_ms_per_launch`` reads it."""

from slam_bench import flops, peaks

READS = ("device_trace", "spans:lm.pcg", "program_counter:kernel_launches")
KERNELS = ("lin_slots_kernel", "lin_fold_kernel", "chi2_slots_kernel", "reduce2_kernel")


def read(rec):
    dev = rec.device_s(KERNELS)
    calls = rec.spans.get("lm.pcg", [])
    if dev <= 0 or not calls:
        return None
    bound = 0.0
    for c in calls:
        k, l, e1, e2 = (c["counts"][x] for x in ("poses", "landmarks", "odom_edges", "lm_edges"))
        n = c["launches"]
        k1, k2 = peaks.bound_s(*flops.k1(k, l, e2)), peaks.bound_s(*flops.k2(e1))
        bound += (n["fused_linearize"] * (k1 + k2) + n["obs_linearize"] * k1
                  + n["resident_chi2"] * peaks.bound_s(*flops.k3(k, l, e1, e2)))
    return 100.0 * bound / dev
