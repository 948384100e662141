"""Model configurations addressable by ``--arch``."""
