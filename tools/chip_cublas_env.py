"""Host cost of cuBLAS's fixed-workspace setting, which deterministic
training needs (``CUBLAS_WORKSPACE_CONFIG=:4096:8``, set by
``repro_torch.launch.train`` on ``cuda``): ``chip_smoke.py``'s CNF profile,
per-sample profile and ODE-server phases (7, 18, 28) in one process with
the setting (``set``) or without it (``unset``).

    for m in unset set unset set; do python3 tools/chip_cublas_env.py $m; done

Compare the two settings only within one machine, alternating.
"""
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(mode: str):
    if mode not in ("set", "unset"):
        raise SystemExit("usage: chip_cublas_env.py set|unset")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    # before any CUDA call: PyTorch and cuBLAS read the setting there
    if mode == "set":
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    else:
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
    import torch
    print("CUBLAS_WORKSPACE_CONFIG", os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    torch.backends.cuda.matmul.allow_tf32 = False
    os.chdir(ROOT)
    cs.build()
    cs.profile_step()
    cs.per_sample_profile()
    cs.serve_ode_main_path()


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "")
