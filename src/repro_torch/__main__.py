from repro_torch.cli import main

raise SystemExit(main())
