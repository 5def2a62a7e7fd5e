"""The plain reference: DESIGN.md's count, correction, assembly and
validation worked out again in plain torch (CPU or card) from the
benchmark's own inputs, after the semantics of oracle/. It imports nothing
of kmerax_torch, kmerax or oracle, and takes nothing the program made."""
