"""Utilities of the port: `.pth` interop."""
