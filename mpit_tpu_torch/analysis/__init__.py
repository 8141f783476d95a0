"""Runtime sanitizers of the port: a stand-in until ROADMAP.md item A12."""
