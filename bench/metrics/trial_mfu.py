"""The whole §5 trial's share of the card's float32 peak in the traced
slice: the reference's model FLOPs of every instance-trial the slice ran
(``harness.kernel_work.s5_model_flops``) over the slice's length and the
peak (67 TFLOP/s at 700 W; the card's power limit is on the result
line), in percent. It reads the same work whatever implements it."""


def read(run):
    s = (run.trace or {}).get("summary")
    if s is None or run.peaks is None or s["window_s"] <= 0:
        return None
    flops = run.system.model_flops(run.trace["calls"])
    return 100.0 * flops / s["window_s"] / run.peaks["fp32_flops"]
