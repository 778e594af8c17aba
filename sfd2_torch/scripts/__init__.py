"""Drivers that run the port end to end at scale (``python -m sfd2_torch.scripts.<name>``)."""
