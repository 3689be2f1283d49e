"""The frozen work arithmetic: a clip's model FLOPs and K5a's bytes and operations."""
