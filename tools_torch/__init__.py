"""PyTorch counterparts of ``tools/``'s accelerator tools, run on the card
by ``python3 -m tools_torch.<name>`` from the repo root:

  validate_cuda   statistical acceptance of float32 Gibbs products
                  (``tools/validate_tpu.py``), written to VALIDATE_CUDA.json;
  scale_envelope  the plain engine's memory and time along N, the
                  kernel-sharded engine's cost and the routing rule
                  (``tools/scale_envelope.py``);
  span_cost       the host cost of the port's spans (utils/spans.py) on a
                  ``*`` request and a serving call, recorded and not (no
                  counterpart in ``tools/``).

All three import torch, numpy and ``kde_tpu_torch`` only.  They run on the card
unless a caller passes ``device="cpu"`` (the tests do); without a card they
raise, and nothing falls back to the CPU.  Importing a tool runs nothing.
"""

import socket
import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """``device``, or the card when it is None; raises when the device is a
    CUDA device and there is no card."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this tool runs on a CUDA card and "
                           "torch.cuda.is_available() is false; pass "
                           "device='cpu' to run it on the CPU")
    return device


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them; ``"cpu"`` on the
    CPU."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[device.index or 0].strip()


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free_port() -> int:
    """A free TCP port on localhost, for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
