// The check every launcher and card query of the kernel library makes
// first: the card it is given is the current one.  The Python side makes
// it so (_build.launch and _build.query run every call under
// torch.cuda.device), and nothing here switches the card, so no call
// leaves the process on another one.
#pragma once

#include <cuda_runtime.h>

struct BisOnDevice {
    cudaError_t err = cudaSuccess;

    explicit BisOnDevice(int device) {
        int cur = -1;
        err = cudaGetDevice(&cur);
        if (err == cudaSuccess && cur != device) err = cudaErrorInvalidDevice;
    }
};
