"""bucket_route_roofline.job: kernel 1 (bucket_ranks) on one extra job run
in host mode: the sum over its calls of the bytes each must move over the
card's published memory rate, over the sum of their device times. Only
where the job launches kernel 1."""


def read(run):
    k = run.kernel_times.get("bucket_ranks")
    if not run.jobs or not k:
        return None
    return 100.0 * k["bound_s"] / k["time_s"]
