"""Operator tools of the port (counterparts of the JAX package's
``tools/``), each run as ``python -m torchdistx_tpu_torch.tools.<name>``
and printing one JSON summary line last on stdout:

* :mod:`.reshard_ctl` — plan / apply / verify an offline reshard of a
  committed checkpoint (no GPU needed);
* :mod:`.warm_cache` — build or fetch the kernel libraries of a path
  into a local cache and a shared artifact registry, sharded across
  hosts;
* :mod:`.registry_ctl` — ls / stats / verify / gc over a registry
  directory (the directory contract alone, with the standard library).
"""
