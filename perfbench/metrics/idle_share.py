"""idle_share.query / .update (%): the share of the traced span in which
no kernel, copy or fill ran on the device: 1 - (union of the device
records' intervals / the span), from `torch.profiler`."""


def read(run):
    summary = (run.traced or {}).get("summary") or {}
    if summary.get("window_s", 0) <= 0 or summary.get("busy_s", 0) <= 0:
        return None
    return 100 * (1 - summary["busy_s"] / summary["window_s"])
