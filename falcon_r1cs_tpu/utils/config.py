"""Runtime configuration: the replacement for the reference's compile-time
cargo feature flags (`/root/reference/falcon-r1cs/Cargo.toml:28-32`;
SURVEY.md section 5 "Config/flag system").

Both parameter sets are co-resident; engine/runtime knobs live here rather
than in build flags since JAX retraces per static configuration anyway.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path


@dataclasses.dataclass
class RuntimeConfig:
    # default parameter set for CLIs/benches (512 or 1024)
    default_n: int = 1024
    # validate gadget inputs at trace time (the runtime analog of the
    # reference's #[cfg(not(test))] panic guards)
    validate: bool = True
    # witness engine hint-NTT backend (ops/backend.py): None = the
    # platform's choice (the CUDA kernel on a GPU, XLA elsewhere);
    # True = require the kernel (raises where there is none); False = XLA
    use_ntt_kernel: bool | None = None
    # CRT satisfiability primes
    num_crt_primes: int = 24
    # compiled-artifact cache directory (compiled R1CS, CRS files):
    # gitignored, inside the checkout
    artifact_cache: str = str(
        Path(__file__).resolve().parents[2] / ".artifact_cache"
    )

    @classmethod
    def from_env(cls, prefix: str = "FALCON_TPU_") -> "RuntimeConfig":
        cfg = cls()
        for f in dataclasses.fields(cls):
            raw = os.environ.get(prefix + f.name.upper())
            if raw is None:
                continue
            if f.name == "use_ntt_kernel":
                cfg.use_ntt_kernel = (
                    None if raw.lower() == "auto"
                    else raw.lower() in ("1", "true", "yes")
                )
            elif f.type in ("int", int):
                setattr(cfg, f.name, int(raw))
            elif f.type in ("bool", bool):
                setattr(cfg, f.name, raw.lower() in ("1", "true", "yes"))
            else:
                setattr(cfg, f.name, raw)
        return cfg


_CONFIG: RuntimeConfig | None = None


def get_config() -> RuntimeConfig:
    global _CONFIG
    if _CONFIG is None:
        _CONFIG = RuntimeConfig.from_env()
    return _CONFIG


def set_config(cfg: RuntimeConfig) -> None:
    global _CONFIG
    _CONFIG = cfg
