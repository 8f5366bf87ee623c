"""``python -m qfa_tpu_torch`` — module entry of the ``qfa-tpu-torch`` CLI."""

from .cli import main

if __name__ == "__main__":
    main()
