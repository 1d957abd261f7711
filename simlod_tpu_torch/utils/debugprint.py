"""Device->host debug print and key/value channel — the CudaPrint analogue
(C16; port of simlod_tpu/utils/debugprint.py).

The reference's CudaPrint (modules/CudaPrint/CudaPrint.cuh/.h) gives device code a
printf-like channel plus a key/value table polled asynchronously by the host.
PyTorch runs eagerly, so both become host calls that read device tensors:

  - dprint(fmt, *tensors): one device read of all the tensors, then a print.
  - KVChannel: a named table of device scalars (kv.set("name", value) keeps the
    tensor, no read); `to_host` reads every value in one stacked read, as
    Engine._read does.

`host_syncs` counts the device reads made here.
"""
from __future__ import annotations

import numpy as np
import torch

host_syncs = 0


def dprint(fmt: str, *tensors):
    """Print `fmt.format(*values)` (the reference's device printf /
    CudaPrint::print) after one device read of all the tensors: each is
    copied to the host without waiting, then the devices are waited on
    once."""
    global host_syncs
    host_syncs += 1
    host = [t.detach().to("cpu", non_blocking=True) for t in tensors]
    for d in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.synchronize(d)
    print(fmt.format(*(h.tolist() for h in host)), flush=True)


class KVChannel:
    """Key/value scalar channel (reference CudaPrint::set).

    Usage:
        kv = KVChannel()
        ...
        kv.set("num_split_rounds", rounds)     # a device scalar, not read
        host = KVChannel.to_host(kv.values())  # every value in one read
    """

    def __init__(self):
        self._vals: dict[str, torch.Tensor] = {}

    def set(self, key: str, value):
        self._vals[key] = torch.as_tensor(value).reshape(())

    def values(self) -> dict:
        return dict(self._vals)

    @staticmethod
    def to_host(values: dict) -> dict:
        """Device scalars -> Python numbers in one stacked read: every value
        rides as a 64-bit word (floats as their float64 bits), so ints stay
        exact and floats keep their float64 value."""
        global host_syncs
        if not values:
            return {}
        host_syncs += 1
        dev = next(iter(values.values())).device
        words = []
        for v in values.values():
            v = v.to(dev)
            words.append(v.to(torch.float64).view(torch.int64)
                         if v.is_floating_point() else v.to(torch.int64))
        host = torch.stack(words).tolist()
        as_f64 = np.asarray(host, np.int64).view(np.float64)
        out = {}
        for i, (k, v) in enumerate(values.items()):
            if v.is_floating_point():
                out[k] = float(as_f64[i])
            elif v.dtype == torch.bool:
                out[k] = bool(host[i])
            else:
                out[k] = host[i]
        return out
