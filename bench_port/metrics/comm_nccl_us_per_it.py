"""Device time of the communicator's NCCL kernels (the halo exchange's
send / receive, the dots' and the answer's all-gathers, their waits for the
peer included) in rank 0's traced stretch, in µs over the inner
iterations of the requests it covered.  Nothing is read without a card
(no device operation in the trace) or where no NCCL kernel ran."""


def read(run):
    if not run.profiles or not run.profiled:
        return None
    seconds = [sec for short, _, sec in run.profiles[0].device_ops
               if short.lower().startswith("nccl")]
    its = run.its(run.profiled)
    return 1e6 * sum(seconds) / its if seconds and its else None
