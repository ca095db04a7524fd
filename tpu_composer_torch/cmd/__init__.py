"""Process entry points (port of ``tpu_composer/cmd/``; reference analog:
cmd/main.go)."""
