"""Native (C++) components, built from source at first use (see build.py)."""
