"""The reference's LPIPS proxy."""
