"""Tensor layouts over a device mesh (DTensor)."""
