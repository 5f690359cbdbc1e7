"""Percent of the time the device stretch's points take untraced in which
no kernel, copy or set runs on the device: the busy time of the
device-only trace over the host-clock seconds of the same points (same
seeds) run untraced just before the window, so the profiler's own cost on
the host does not count as idle."""


def read(run):
    untraced = sum(run.host.get("untraced_point", []))
    if run.device is None or not run.device.has_device or untraced <= 0:
        return None
    return 100.0 * (1.0 - run.device.busy_s / untraced)
