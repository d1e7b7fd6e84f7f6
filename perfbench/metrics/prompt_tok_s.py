"""prompt_tok_s: real prompt tokens of the window's requests over the window (host clock)."""

from perfbench.readers import prompt_tok_s as read

__all__ = ["read"]
