from .gae import gae_scan, vtrace_block, vtrace_scan

__all__ = ["gae_scan", "vtrace_block", "vtrace_scan"]
