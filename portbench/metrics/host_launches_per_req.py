"""host_launches_per_req.<family>: host calls that hand the device work
(cudaLaunchKernel, cudaGraphLaunch and the copies, cudaMemcpy*), per
completed request, from the profiler's runtime events."""


def read(td):
    if not td.requests:
        return None
    return sum(td.host_calls.values()) / td.requests
