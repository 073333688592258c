"""seg_combine_roofline.job: kernel 2 (segment_combine) on one extra job
run in host mode: the sum over its calls of the bytes each must move over
the card's published memory rate, over the sum of their device times."""


def read(run):
    k = run.kernel_times.get("segment_combine")
    if not run.jobs or not k:
        return None
    return 100.0 * k["bound_s"] / k["time_s"]
