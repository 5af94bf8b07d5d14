from repro_torch.telemetry.report import main

raise SystemExit(main())
