from tpu_composer_torch.cmd.main import main

raise SystemExit(main())
