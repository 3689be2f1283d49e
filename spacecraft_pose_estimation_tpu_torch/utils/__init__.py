"""Weight files in and out: reference ``.pth`` and zoo ``.pkl`` checkpoints onto the port's modules, and back."""
