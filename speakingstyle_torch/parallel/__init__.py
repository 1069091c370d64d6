"""Program preparation and the precision casts (JAX counterpart:
speakingstyle_tpu/parallel). The mesh and partitioning modules wait for
multi-device serving (ROADMAP.md queue A item 6)."""
